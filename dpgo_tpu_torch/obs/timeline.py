"""Fleet timeline: merge per-robot event streams, align clocks, export a
Perfetto-loadable Chrome trace.

Each robot process writes its own ``events.jsonl`` with its own monotonic
clock — an island.  This module joins the islands:

1. **Clock alignment.**  Every stamped frame (heartbeats included) the
   comms layer receives with telemetry on produced a ``clock_sample``
   event: the sender's clock at send (``t_send_mono``) next to the
   receiver's clock at receipt (the event's own ``t_mono``).  A one-way
   delta ``recv - send`` equals ``offset + latency``; with samples in
   both directions the latency cancels in
   ``(median(a->b) - median(b->a)) / 2`` and the remainder is the
   pairwise clock offset, reported with an uncertainty of half the
   median round-trip plus the sample spread (MAD).  Offsets propagate
   from a reference stream (the bus hub when present) over the sample
   graph, so robots that never exchanged directly still land on one
   timeline through the hub.  One-direction-only pairs cannot separate
   offset from latency — they are used with the latency bias left in and
   flagged ``bidirectional: false`` with a wider uncertainty.

2. **Span merge.**  All events are rebased onto the reference clock
   (``t_mono``, ``t0_mono``, and ``link_t_mono`` fields shifted by the
   stream offset) and tagged with their source stream.

3. **Chrome trace export.**  ``to_chrome_trace`` renders one process per
   robot (the bus hub is its own track), threads split by phase
   (compute / comms / solver), spans as complete (``X``) events, select
   events (``peer_lost``, solve lifecycle) as instants, and every
   cross-robot ``link_*`` span edge as a flow arrow (``s``/``f``) from
   the sender's publish to the receiver's scatter.  Load the file in
   https://ui.perfetto.dev or ``chrome://tracing``.

CLI::

    python -m dpgo_tpu_torch.obs.timeline RUN_DIR [RUN_DIR...] \
        [-o trace.json] [--report]

Pure host-side: reads JSONL, writes JSON, touches no devices.

The PyTorch port's copy of ``dpgo_tpu.obs.timeline``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
from collections import defaultdict

import numpy as np

from .events import read_events_meta
from .run import EVENTS_FILE

#: Span names that are blocking waits on the wire (the robot is idle).
WAIT_SPANS = ("collect", "exchange_wait", "drain")
#: Span names that measure wire work (hidden under compute in overlap
#: mode when the worker thread runs them).
WIRE_SPANS = ("publish", "collect", "wire_round", "bus_round")


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stream:
    """One event file = one clock domain."""

    path: str
    events: list
    truncated: bool
    robots: set                      # robot ids whose spans live here
    home: int | None = None          # the stream's own robot (-1 = bus)
    offset: float = 0.0              # seconds; subtract to rebase
    uncertainty: float | None = None
    aligned: bool = True             # False: no sample path to reference


def _events_path(path: str) -> str:
    """Accept a run dir (holding ``events.jsonl``) or a jsonl file."""
    if os.path.isdir(path):
        return os.path.join(path, EVENTS_FILE)
    return path


def load_stream(path: str) -> Stream:
    ev_path = _events_path(path)
    events, truncated = read_events_meta(ev_path)
    robots = set()
    tally: dict = defaultdict(int)
    for e in events:
        if e.get("event") == "span" and "robot" in e:
            robots.add(int(e["robot"]))
            tally[int(e["robot"])] += 1
    # Home preference: a fleet-plane actor (multihost rank <= -100 /
    # procs replica <= -200 / launcher -5 — comms.protocol's bands)
    # identifies the PROCESS that wrote this stream, so it wins over the
    # solver's per-agent robot ids even when agent spans outnumber the
    # plane's barrier/boot spans.
    plane = {r: n for r, n in tally.items() if r <= -100 or r == -5}
    if plane:
        home = max(plane, key=plane.get)
    else:
        home = max(tally, key=tally.get) if tally else None
    return Stream(path=path, events=events, truncated=truncated,
                  robots=robots, home=home)


def robot_stream_map(streams: list[Stream]) -> dict:
    """robot id -> index of the stream that owns its spans (first wins)."""
    out: dict = {}
    for i, s in enumerate(streams):
        for r in sorted(s.robots):
            out.setdefault(r, i)
    return out


# ---------------------------------------------------------------------------
# Clock-offset estimation
# ---------------------------------------------------------------------------

def _median(xs):
    return float(np.median(np.asarray(xs, np.float64)))


def _mad(xs):
    a = np.asarray(xs, np.float64)
    return float(1.4826 * np.median(np.abs(a - np.median(a))))


def pairwise_deltas(streams: list[Stream],
                    robot_of: dict) -> dict:
    """``{(sender_stream, receiver_stream): [recv_mono - send_mono]}``
    from every ``clock_sample`` event; same-stream samples (loopback:
    identical clock) are dropped."""
    deltas: dict = defaultdict(list)
    for j, s in enumerate(streams):
        for e in s.events:
            if e.get("event") != "clock_sample":
                continue
            src = e.get("src")
            if src is None or src == -2:
                continue
            i = robot_of.get(int(src))
            if i is None or i == j:
                continue
            try:
                deltas[(i, j)].append(
                    float(e["t_mono"]) - float(e["t_send_mono"]))
            except (KeyError, TypeError, ValueError):
                continue
    return dict(deltas)


def estimate_offsets(streams: list[Stream]) -> dict:
    """Estimate per-stream clock offsets relative to a reference stream
    and write them onto the ``Stream`` objects.

    Reference choice: the stream owning the bus hub (robot -1) when
    present — every robot exchanges with the hub, so it is the natural
    center of the sample graph — else the fleet launcher/manager
    (actor -5: it exchanges spawn/harvest/heartbeat samples with every
    rank and replica), else the stream owning robot 0, else stream 0.
    Returns a report dict (per-stream offset, uncertainty, sample
    counts, pair diagnostics)."""
    robot_of = robot_stream_map(streams)
    ref = robot_of.get(-1, robot_of.get(-5, robot_of.get(0, 0)))
    deltas = pairwise_deltas(streams, robot_of)

    # Symmetric pair estimates: offset o[j] - o[i] for each sampled pair.
    pair_est: dict = {}
    seen = set()
    for (i, j) in deltas:
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        a, b = key
        d_ab, d_ba = deltas.get((a, b)), deltas.get((b, a))
        if d_ab and d_ba:
            med_ab, med_ba = _median(d_ab), _median(d_ba)
            off = (med_ab - med_ba) / 2.0        # clock_b - clock_a
            half_rtt = max(0.0, (med_ab + med_ba) / 2.0)
            unc = half_rtt + max(_mad(d_ab), _mad(d_ba))
            pair_est[key] = {"offset": off, "uncertainty": unc,
                             "bidirectional": True,
                             "samples": len(d_ab) + len(d_ba)}
        else:
            d, sign = (d_ab, 1.0) if d_ab else (d_ba, -1.0)
            med = _median(d)
            # One-way: the (nonnegative) latency is inseparable from the
            # offset — keep the biased estimate, widen the uncertainty.
            pair_est[key] = {"offset": sign * med,
                             "uncertainty": abs(med) + _mad(d),
                             "bidirectional": False, "samples": len(d)}

    # Propagate from the reference over the pair graph (BFS).
    for s in streams:
        s.offset, s.uncertainty, s.aligned = 0.0, None, False
    streams[ref].offset, streams[ref].uncertainty = 0.0, 0.0
    streams[ref].aligned = True
    frontier = [ref]
    while frontier:
        i = frontier.pop()
        for (a, b), est in pair_est.items():
            for (src, dst, sign) in ((a, b, 1.0), (b, a, -1.0)):
                if src == i and not streams[dst].aligned:
                    streams[dst].offset = \
                        streams[i].offset + sign * est["offset"]
                    streams[dst].uncertainty = \
                        (streams[i].uncertainty or 0.0) + est["uncertainty"]
                    streams[dst].aligned = True
                    frontier.append(dst)

    return {
        "reference": streams[ref].path,
        "streams": [{
            "path": s.path, "home": s.home,
            "offset_s": round(s.offset, 6),
            "uncertainty_s": (None if s.uncertainty is None
                              else round(s.uncertainty, 6)),
            "aligned": s.aligned, "truncated": s.truncated,
        } for s in streams],
        "pairs": [{
            "streams": [streams[a].path, streams[b].path],
            "offset_s": round(est["offset"], 6),
            "uncertainty_s": round(est["uncertainty"], 6),
            "bidirectional": est["bidirectional"],
            "samples": est["samples"],
        } for (a, b), est in sorted(pair_est.items())],
    }


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Timeline:
    """Merged, clock-rebased view over N streams."""

    streams: list
    events: list            # rebased copies, sorted by t_mono, + _stream
    offsets: dict           # the estimate_offsets report
    robot_of: dict          # robot id -> stream index


_REBASE_FIELDS = ("t_mono", "t0_mono")


def merge(paths: list[str]) -> Timeline:
    """Load, align, and rebase the given run dirs / event files onto the
    reference clock."""
    streams = [load_stream(p) for p in paths]
    report = estimate_offsets(streams)
    robot_of = robot_stream_map(streams)
    merged = []
    for i, s in enumerate(streams):
        for e in s.events:
            e2 = dict(e)
            for f in _REBASE_FIELDS:
                if f in e2 and isinstance(e2[f], (int, float)):
                    e2[f] = float(e2[f]) - s.offset
            # link_t_mono is on the SENDER's clock — rebase by the
            # sender's stream offset, not the receiver's.
            if "link_t_mono" in e2 and "link_robot" in e2:
                li = robot_of.get(int(e2["link_robot"]))
                off = streams[li].offset if li is not None else s.offset
                e2["link_t_mono"] = float(e2["link_t_mono"]) - off
            e2["_stream"] = i
            merged.append(e2)
    merged.sort(key=lambda e: e.get("t_mono", 0.0))
    return Timeline(streams=streams, events=merged, offsets=report,
                    robot_of=robot_of)


# ---------------------------------------------------------------------------
# Fleet statistics (the report CLI's "fleet timeline" section)
# ---------------------------------------------------------------------------

def fleet_timeline_stats(events: list[dict]) -> dict | None:
    """Busy/wait/wire breakdown per robot, per-round critical path,
    straggler ranking, and overlap efficiency from ``span`` events (raw
    or merged).  None when the stream carries no spans."""
    spans = [e for e in events if e.get("event") == "span"]
    if not spans:
        return None
    per = defaultdict(lambda: {"busy_s": 0.0, "wait_s": 0.0, "wire_s": 0.0,
                               "hidden_wire_s": 0.0, "iterations": 0,
                               "iter_durs": []})
    rounds: dict = defaultdict(list)   # iteration -> [(t0, t1, robot)]
    flows = 0
    t_lo, t_hi = math.inf, -math.inf
    for e in spans:
        dur = float(e.get("dur_s", 0.0))
        t0 = float(e.get("t0_mono", 0.0))
        t_lo, t_hi = min(t_lo, t0), max(t_hi, t0 + dur)
        if "link_span" in e:
            flows += 1
        r = e.get("robot")
        if r is None:
            continue
        row = per[int(r)]
        name = e.get("name", "")
        if e.get("phase") == "compute":
            row["busy_s"] += dur
            if name == "iterate":
                row["iterations"] += 1
                row["iter_durs"].append(dur)
                if "iteration" in e:
                    rounds[int(e["iteration"])].append(
                        (t0, t0 + dur, int(r)))
        elif name in WAIT_SPANS:
            row["wait_s"] += dur
        if name == "wire_round":
            row["hidden_wire_s"] += dur
        if name in WIRE_SPANS:
            row["wire_s"] += dur

    robots = {}
    for r, row in sorted(per.items()):
        durs = row.pop("iter_durs")
        mean_it = float(np.mean(durs)) if durs else None
        hidden = row["hidden_wire_s"]
        eff = None
        if hidden > 0:
            # Overlap efficiency: the worker's wire time that did NOT
            # resurface as caller-side blocking (exchange_wait + drain).
            eff = max(0.0, min(1.0, 1.0 - row["wait_s"] / hidden))
        robots[r] = {**{k: round(v, 6) for k, v in row.items()},
                     "mean_iterate_s": (None if mean_it is None
                                        else round(mean_it, 6)),
                     "overlap_efficiency": (None if eff is None
                                            else round(eff, 4))}

    crit = defaultdict(int)
    makespans = []
    for it, rows in rounds.items():
        if len(rows) < 2:
            continue
        start = min(t0 for t0, _, _ in rows)
        end, crit_robot = max((t1, r) for _, t1, r in rows)
        makespans.append(end - start)
        crit[crit_robot] += 1
    round_stats = None
    if makespans:
        round_stats = {
            "rounds": len(makespans),
            "mean_makespan_s": round(float(np.mean(makespans)), 6),
            "p95_makespan_s": round(float(np.percentile(makespans, 95)), 6),
            "critical_path_counts": dict(sorted(
                crit.items(), key=lambda kv: -kv[1])),
        }

    stragglers = sorted(
        ((r, row["mean_iterate_s"]) for r, row in robots.items()
         if row["mean_iterate_s"] is not None and r >= 0),
        key=lambda kv: -(kv[1] or 0.0))
    return {
        "window_s": round(t_hi - t_lo, 6) if t_hi > t_lo else 0.0,
        "num_spans": len(spans),
        "num_flow_links": flows,
        "robots": robots,
        "round_critical_path": round_stats,
        "straggler_ranking": [
            {"robot": r, "mean_iterate_s": round(d, 6)}
            for r, d in stragglers],
    }


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

#: phase -> thread id inside each robot's process track.
_PHASE_TID = {"compute": 0, "comms": 1, "solve": 2, "eval": 2, "serve": 4}
_TID_NAMES = {0: "compute", 1: "comms", 2: "solver", 3: "events",
              4: "serving"}

#: Events rendered as instants on the timeline.  The fleet plane
#: adds process/generation lifecycle instants — a kill -9
#: renders as ``process_lost`` on the victim's own track.
_INSTANT_EVENTS = ("peer_lost", "solve_start", "solve_end", "run_start",
                   "run_end", "agent_state", "overlap_decision",
                   "process_lost", "generation_start", "generation_end",
                   "generation_postmortem", "replica_postmortem",
                   "verdict_publish")

#: The device-attribution track: ``device_attribution``
#: events carry window-relative XLA op slices; they render as their own
#: process with one thread per device lane, far above the robot pids.
_PID_DEVICE = 1000

#: Fleet-plane track bands, mirroring the actor-id bands in
#: ``comms.protocol``: the launcher/manager (actor -5) gets its own
#: track, multihost rank r (actor -100-r) the 300 band, out-of-process
#: replica i (actor -200-i) the 500 band — all visually separated from
#: robots (2+) and below/around the device track.
_PID_LAUNCHER = 200
_PID_RANK_BASE = 300
_PID_REPLICA_BASE = 500


def _pid(robot) -> int:
    """Track id: 0 = host/driver, 1 = bus hub, 2+r = robot r, plus the
    fleet bands above.  The serving-plane origin sentinels (-3/-4,
    ``comms.protocol.ORIGIN_SERVE_*``) map onto the host track — serve
    spans carry no robot, so their flow arrows must start where the
    spans render."""
    if robot is None:
        return 0
    robot = int(robot)
    if robot <= -200:
        return _PID_REPLICA_BASE + (-robot - 200)
    if robot <= -100:
        return _PID_RANK_BASE + (-robot - 100)
    if robot == -5:
        return _PID_LAUNCHER
    if robot <= -3:
        return 0
    return 1 if robot < 0 else 2 + robot


def _pid_name(pid: int) -> str:
    if pid == 0:
        return "host"
    if pid == 1:
        return "bus"
    if pid == _PID_LAUNCHER:
        return "launcher"
    if _PID_RANK_BASE <= pid < _PID_REPLICA_BASE:
        return f"rank {pid - _PID_RANK_BASE}"
    if pid >= _PID_REPLICA_BASE:
        return f"replica {pid - _PID_REPLICA_BASE}"
    return f"robot {pid - 2}"


def to_chrome_trace(timeline: Timeline) -> dict:
    """Chrome trace-event JSON (dict) from a merged timeline."""
    evs = timeline.events
    t_base = min((e["t0_mono"] for e in evs
                  if e.get("event") == "span" and "t0_mono" in e),
                 default=min((e.get("t_mono", 0.0) for e in evs),
                             default=0.0))

    def us(t):
        return round((float(t) - t_base) * 1e6, 3)

    out = []
    pids_used: dict = {}
    tids_used: set = set()

    def track(robot, stream_idx):
        if robot is None:
            s = timeline.streams[stream_idx]
            robot = s.home
        pid = _pid(robot)
        pids_used[pid] = _pid_name(pid)
        return pid

    flow_seq = 0
    for e in evs:
        kind = e.get("event")
        if kind == "span":
            pid = track(e.get("robot"), e["_stream"])
            tid = _PHASE_TID.get(e.get("phase"), 3)
            tids_used.add((pid, tid))
            args = {k: v for k, v in e.items()
                    if k not in ("event", "name", "phase", "seq", "run",
                                 "t_wall", "t_mono", "t0_mono", "t0_wall",
                                 "dur_s", "_stream")}
            rec = {"name": e.get("name", "span"),
                   "cat": e.get("phase") or "span", "ph": "X",
                   "ts": us(e["t0_mono"]),
                   "dur": max(round(float(e.get("dur_s", 0.0)) * 1e6, 3),
                              0.001),
                   "pid": pid, "tid": tid, "args": args}
            out.append(rec)
            if "link_span" in e and "link_t_mono" in e:
                # Flow arrow: sender publish -> this span.  One unique id
                # per edge (a publish fans out to many receivers; each
                # edge is its own s/f pair so every arrow renders).
                flow_seq += 1
                fid = f"{e['link_span']}.{flow_seq}"
                spid = _pid(e.get("link_robot"))
                pids_used[spid] = _pid_name(spid)
                tids_used.add((spid, 1))
                s_ts = us(e["link_t_mono"])
                f_ts = max(rec["ts"], s_ts)  # clamp: offset noise must
                out.append({"name": "frame", "cat": "frame", "ph": "s",
                            "id": fid, "pid": spid, "tid": 1, "ts": s_ts})
                out.append({"name": "frame", "cat": "frame", "ph": "f",
                            "bp": "e", "id": fid, "pid": pid, "tid": tid,
                            "ts": f_ts})  # not break s<=f ordering
        elif kind == "device_attribution":
            # Device track: the window's XLA op slices, anchored so the
            # window ENDS at the event's (rebased) emission stamp — the
            # slices' t0_s are window-relative.  Alignment to host spans
            # is as good as the stop-to-emit latency (attribution parse
            # time), which is fine for a visual correlation track.
            window_s = float(e.get("window_s") or 0.0)
            anchor = float(e.get("t_mono", t_base)) - window_s
            pids_used[_PID_DEVICE] = "device"
            for sl in e.get("slices") or []:
                tid = int(sl.get("lane", 0))
                tids_used.add((_PID_DEVICE, tid))
                out.append({
                    "name": str(sl.get("op", "op")),
                    "cat": str(sl.get("kind", "compute")), "ph": "X",
                    "ts": us(anchor + float(sl.get("t0_s", 0.0))),
                    "dur": max(round(float(sl.get("dur_s", 0.0)) * 1e6, 3),
                               0.001),
                    "pid": _PID_DEVICE, "tid": tid,
                    "args": {"kind": sl.get("kind"),
                             "label": e.get("label"),
                             "plane": e.get("phase")}})
        elif kind in _INSTANT_EVENTS:
            pid = track(e.get("robot"), e["_stream"])
            tids_used.add((pid, 3))
            args = {k: v for k, v in e.items()
                    if k not in ("event", "seq", "run", "t_wall", "t_mono",
                                 "_stream")}
            out.append({"name": kind, "cat": "event", "ph": "i",
                        "s": "p", "ts": us(e.get("t_mono", t_base)),
                        "pid": pid, "tid": 3, "args": args})

    meta = []
    for pid, name in sorted(pids_used.items()):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": name}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "args": {"sort_index": pid}})
    for pid, tid in sorted(tids_used):
        tname = f"device lane {tid}" if pid == _PID_DEVICE \
            else _TID_NAMES.get(tid, "events")
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})

    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"clock_alignment": timeline.offsets}}


def write_chrome_trace(path: str, timeline: Timeline) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(to_chrome_trace(timeline), fh)
    os.replace(tmp, path)
    return path


def validate_chrome_trace(obj) -> dict:
    """Structural validation of an exported trace (dict or file path).
    Raises ``ValueError`` on schema violations; returns summary counts —
    the round-trip check the CI smoke runs on the exported file."""
    if isinstance(obj, str):
        with open(obj) as fh:
            obj = json.load(fh)
    if not isinstance(obj, dict) or \
            not isinstance(obj.get("traceEvents"), list):
        raise ValueError("not a Chrome trace: missing traceEvents list")
    spans = 0
    flow_s: dict = {}
    flow_f: dict = {}
    pids = set()
    for e in obj["traceEvents"]:
        ph = e.get("ph")
        if ph is None or "pid" not in e:
            raise ValueError(f"trace event missing ph/pid: {e}")
        pids.add(e["pid"])
        if ph == "M":
            continue
        if not isinstance(e.get("ts"), (int, float)):
            raise ValueError(f"trace event missing numeric ts: {e}")
        if ph == "X":
            spans += 1
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                raise ValueError(f"X event missing/negative dur: {e}")
        elif ph == "s":
            if e.get("id") in flow_s:
                raise ValueError(f"duplicate flow start id {e.get('id')}")
            flow_s[e["id"]] = e
        elif ph == "f":
            if e.get("id") in flow_f:
                raise ValueError(f"duplicate flow finish id {e.get('id')}")
            flow_f[e["id"]] = e
    if set(flow_s) != set(flow_f):
        raise ValueError(
            f"unbalanced flow events: {len(flow_s)} starts vs "
            f"{len(flow_f)} finishes")
    for fid, s in flow_s.items():
        if flow_f[fid]["ts"] < s["ts"]:
            raise ValueError(f"flow {fid} finishes before it starts")
    cross = sum(1 for fid, s in flow_s.items()
                if flow_f[fid]["pid"] != s["pid"])
    return {"spans": spans, "flows": len(flow_s),
            "cross_robot_flows": cross, "pids": len(pids)}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dpgo_tpu_torch.obs.timeline", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("inputs", nargs="+",
                    help="run directories (holding events.jsonl) or "
                         "event files, one per robot/process")
    ap.add_argument("-o", "--out", default=None,
                    help="Chrome trace output path (default: trace.json "
                         "next to the first input)")
    ap.add_argument("--report", action="store_true",
                    help="also print the fleet timeline statistics")
    args = ap.parse_args(argv)

    missing = [p for p in args.inputs
               if not os.path.exists(_events_path(p))]
    if missing:
        print(f"no events found under: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    tl = merge(args.inputs)
    if not tl.events:
        print("no events in any input stream", file=sys.stderr)
        return 2
    out = args.out
    if out is None:
        base = args.inputs[0]
        base_dir = base if os.path.isdir(base) else os.path.dirname(base)
        out = os.path.join(base_dir, "trace.json")
    write_chrome_trace(out, tl)
    counts = validate_chrome_trace(out)
    print(f"wrote {out}: {counts['spans']} spans, {counts['flows']} flow "
          f"edges ({counts['cross_robot_flows']} cross-robot) over "
          f"{counts['pids']} tracks — load in https://ui.perfetto.dev")
    for s in tl.offsets["streams"]:
        unc = ("?" if s["uncertainty_s"] is None
               else f"±{s['uncertainty_s'] * 1e3:.3f}ms")
        tag = "" if s["aligned"] else "  [UNALIGNED: no sample path]"
        tag += "  [truncated tail]" if s["truncated"] else ""
        print(f"  clock {s['path']}: offset {s['offset_s'] * 1e3:+.3f}ms "
              f"{unc}{tag}")
    if args.report:
        stats = fleet_timeline_stats(tl.events)
        print(json.dumps({"fleet_timeline": stats}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

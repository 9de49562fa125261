"""Convergence regression gate: ``report --compare runA runB``.

Compares two telemetry run directories' convergence trajectories and
terminal metrics and exits non-zero on regression — the convergence
analog of the CI perf smoke.  The comparison:

* **Fingerprint gate.**  Both runs' config fingerprints (``run_summary``
  ``channel="config"`` events / ``run.json``) must agree on every shared
  identity key (dataset, num_robots, rank, schedule, wire format, ...);
  an apples-to-oranges comparison is refused with a clear message rather
  than producing a meaningless delta table.  Package version is recorded
  but never gates — comparing across versions is the point of the gate.
* **Terminal metrics with noise bands.**  For each gated metric run B's
  final value is checked against run A's tail *noise band* (min/median/
  max over the last ``tail`` evals — the ``cpu_arm_band`` schema of
  ``bench.py``'s metric_record) widened by ``rtol``.  ``GATED_METRICS``
  declares each metric's improvement direction: lower-is-better metrics
  (``solver_cost``, ...) regress when B's final exceeds A's band max
  beyond tolerance; higher-is-better metrics (``fleet_qps``) regress
  when B's final drops below A's band min.  Either way a non-finite B
  where A was finite regresses.
* **Trajectory deltas.**  Per-iteration aligned relative deviation over
  the common eval grid, reported per metric (informational).
* **Anomaly gate.**  Run B showing critical ``anomaly`` events where run
  A had none is a regression regardless of the final numbers — a NaN'd
  run that happens to dump a small last cost must not pass.

Exit codes: 0 = no regression, 2 = regression or refused comparison.

The PyTorch port's copy of ``dpgo_tpu.obs.regress``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from .events import read_events_meta
from .run import EVENTS_FILE, META_FILE

#: Gated metrics and their improvement direction.  The host-sync rate is
#: the readback-kill gate: a change that silently reintroduces
#: per-eval device->host fetches into the driver loop regresses here even
#: when the convergence numbers are untouched.  Sharded records gate the
#: same lower-is-better way — the mesh identity rides the run
#: fingerprint (solver=solve_rbcd_sharded, mesh_size, exchange), so a
#: sharded run only ever compares against a same-mesh baseline and a
#: reopened readback on the mesh path fails here too
#: (tests/test_sharded_verdict.py pins it).
#: Fleet records gate both ways: throughput must not drop
#: (``fleet_qps`` — the first higher-is-better metric, mirrored band
#: check against A's tail MIN) and a warm restart must not get slower
#: (``serve_cold_start_seconds``).
#: Resilience records gate the rewind tax: a change that
#: makes a mesh recovery (checkpoint restore + re-shard + recompile)
#: slower regresses ``mesh_recovery_overhead_s`` even when the solve
#: itself is untouched.  Absent on fault-free runs, so only chaos-arm
#: baselines ever compare it.
#: Overlap efficiency gates lower-bounded (higher is better):
#: a change that drops the halo/compute overlap win below the baseline
#: band — in particular a regression from positive to negative — fails
#: the compare even when throughput metrics stay inside tolerance.
GATED_METRICS = {"solver_cost": "lower", "solver_grad_norm": "lower",
                 "host_syncs_per_100_rounds": "lower",
                 "fleet_qps": "higher",
                 "serve_cold_start_seconds": "lower",
                 "mesh_recovery_overhead_s": "lower",
                 "sharded_overlap_efficiency": "higher",
                 "device_overlap_efficiency_measured": "higher"}
#: Fingerprint keys that never gate (recorded for the report only).
NON_GATING_KEYS = {"version"}


def tail_band(values: list[float], k: int = 5) -> dict:
    """Noise band over the trailing ``k`` values — the ``cpu_arm_band``
    key schema (min/median/max + the window itself) from ``bench.py``."""
    window = [float(v) for v in values[-max(k, 1):]]
    finite = [v for v in window if math.isfinite(v)]
    ref = sorted(finite)
    med = (ref[len(ref) // 2] if len(ref) % 2 else
           0.5 * (ref[len(ref) // 2 - 1] + ref[len(ref) // 2])) \
        if ref else float("nan")
    return {"min": min(window) if finite else float("nan"),
            "median": med,
            "max": max(window) if finite else float("nan"),
            "windows": window}


def _trajectory(events: list[dict], metric: str) -> list[tuple]:
    return [(ev.get("iteration", ev.get("seq", 0)), float(ev["value"]))
            for ev in events
            if ev.get("event") == "metric" and ev.get("metric") == metric
            and isinstance(ev.get("value"), (int, float))]


def load_run(run_dir: str) -> dict:
    """Events + merged fingerprint for one run dir; raises ValueError on a
    dir with no event stream."""
    ev_path = os.path.join(run_dir, EVENTS_FILE)
    if not os.path.exists(ev_path):
        raise ValueError(f"not a telemetry run directory (no {EVENTS_FILE}): "
                         f"{run_dir}")
    events, _trunc = read_events_meta(ev_path)
    fingerprint: dict = {}
    for ev in events:
        if ev.get("event") == "run_summary" \
                and ev.get("channel") == "config":
            fingerprint.update(ev.get("fingerprint") or {})
    meta_path = os.path.join(run_dir, META_FILE)
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as fh:
                fingerprint.update(json.load(fh).get("fingerprint") or {})
        except (OSError, ValueError):
            pass
    return {"run_dir": run_dir, "events": events, "fingerprint": fingerprint}


def _critical_anomalies(events: list[dict]) -> int:
    return sum(1 for ev in events if ev.get("event") == "anomaly"
               and ev.get("severity") == "critical")


def compare_runs(dir_a: str, dir_b: str, rtol: float = 0.05,
                 atol: float = 1e-9, tail: int = 5,
                 allow_mismatch: bool = False) -> dict:
    """Full comparison record (see module docstring for the semantics)."""
    a, b = load_run(dir_a), load_run(dir_b)
    shared = set(a["fingerprint"]) & set(b["fingerprint"]) - NON_GATING_KEYS
    mismatches = {k: [a["fingerprint"][k], b["fingerprint"][k]]
                  for k in sorted(shared)
                  if a["fingerprint"][k] != b["fingerprint"][k]}
    out: dict = {
        "run_a": dir_a, "run_b": dir_b,
        "fingerprint_a": a["fingerprint"], "fingerprint_b": b["fingerprint"],
        "fingerprint_mismatches": mismatches,
        "compatible": not mismatches or allow_mismatch,
        "metrics": {}, "regressions": [],
    }
    if mismatches and not allow_mismatch:
        out["rc"] = 2
        return out

    names = sorted({ev.get("metric") for r in (a, b) for ev in r["events"]
                    if ev.get("event") == "metric" and ev.get("metric")})
    for name in names:
        ta, tb = _trajectory(a["events"], name), _trajectory(b["events"], name)
        if not ta or not tb:
            continue
        va, vb = [v for _, v in ta], [v for _, v in tb]
        band_a, band_b = tail_band(va, tail), tail_band(vb, tail)
        a_final, b_final = va[-1], vb[-1]
        direction = GATED_METRICS.get(name)
        # Aligned per-iteration relative deviation (informational).
        da, db = dict(ta), dict(tb)
        common = sorted(set(da) & set(db))
        max_dev = max((abs(db[i] - da[i]) / max(abs(da[i]), atol)
                       for i in common
                       if math.isfinite(da[i]) and math.isfinite(db[i])),
                      default=None)
        regressed = False
        why = None
        if direction == "lower":
            if not math.isfinite(b_final) and math.isfinite(a_final):
                regressed, why = True, "non-finite final value"
            elif math.isfinite(b_final) and math.isfinite(band_a["max"]):
                bound = band_a["max"] * (1.0 + rtol) + atol \
                    if band_a["max"] >= 0 \
                    else band_a["max"] * (1.0 - rtol) + atol
                if b_final > bound:
                    regressed = True
                    why = (f"final {b_final:.6g} above band max "
                           f"{band_a['max']:.6g} (+{rtol * 100:.0f}%)")
        elif direction == "higher":
            if not math.isfinite(b_final) and math.isfinite(a_final):
                regressed, why = True, "non-finite final value"
            elif math.isfinite(b_final) and math.isfinite(band_a["min"]):
                bound = band_a["min"] * (1.0 - rtol) - atol \
                    if band_a["min"] >= 0 \
                    else band_a["min"] * (1.0 + rtol) - atol
                if b_final < bound:
                    regressed = True
                    why = (f"final {b_final:.6g} below band min "
                           f"{band_a['min']:.6g} (-{rtol * 100:.0f}%)")
        entry = {"a_final": a_final, "b_final": b_final,
                 "delta": b_final - a_final
                 if math.isfinite(b_final) and math.isfinite(a_final)
                 else None,
                 "a_band": band_a, "b_band": band_b,
                 "points": [len(ta), len(tb)],
                 "max_rel_deviation": max_dev,
                 "direction": direction, "regressed": regressed,
                 "reason": why}
        out["metrics"][name] = entry
        if regressed:
            out["regressions"].append(name)

    crit_a = _critical_anomalies(a["events"])
    crit_b = _critical_anomalies(b["events"])
    out["critical_anomalies"] = [crit_a, crit_b]
    if crit_b > crit_a:
        out["regressions"].append("anomalies")
        out["metrics"]["anomalies"] = {
            "a_final": crit_a, "b_final": crit_b, "direction": "lower",
            "regressed": True,
            "reason": f"{crit_b} critical anomalies vs {crit_a}"}
    out["rc"] = 2 if out["regressions"] else 0
    return out


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render_compare(cmp: dict) -> str:
    lines = [f"== convergence compare: {cmp['run_a']} vs {cmp['run_b']} =="]
    mism = cmp["fingerprint_mismatches"]
    if mism and not cmp["compatible"]:
        lines.append("REFUSED: runs are not comparable — config "
                     "fingerprints disagree:")
        for k, (va, vb) in sorted(mism.items()):
            lines.append(f"  {k}: {va!r} vs {vb!r}")
        lines.append("(re-run with matching configs, or pass "
                     "--allow-mismatch to compare anyway)")
        return "\n".join(lines)
    if mism:
        lines.append("fingerprint mismatches (overridden by "
                     "--allow-mismatch): " + ", ".join(sorted(mism)))
    else:
        nkeys = len(set(cmp["fingerprint_a"]) & set(cmp["fingerprint_b"]))
        lines.append(f"fingerprint: compatible ({nkeys} shared keys)")
    header = (f"  {'metric':<28} {'A final':>12} {'B final':>12} "
              f"{'delta':>11} {'A tail band':>26}  verdict")
    lines.append(header)
    for name, m in sorted(cmp["metrics"].items()):
        band = m.get("a_band")
        band_s = f"[{_fmt(band['min'])}, {_fmt(band['max'])}]" if band else "-"
        delta = m.get("delta")
        if delta is not None and math.isfinite(m["a_final"]) \
                and abs(m["a_final"]) > 0:
            delta_s = f"{100.0 * delta / abs(m['a_final']):+.2f}%"
        else:
            delta_s = _fmt(delta)
        verdict = "REGRESSED" if m["regressed"] else (
            "ok" if m.get("direction") else "info")
        lines.append(f"  {name:<28} {_fmt(m['a_final']):>12} "
                     f"{_fmt(m['b_final']):>12} {delta_s:>11} "
                     f"{band_s:>26}  {verdict}")
        if m.get("reason"):
            lines.append(f"    ^ {m['reason']}")
    if cmp["regressions"]:
        lines.append(f"RESULT: REGRESSION in {', '.join(cmp['regressions'])}")
    else:
        lines.append("RESULT: no regression")
    return "\n".join(lines)


#: Cross-round ledger trends and their improvement direction.
#: Keys are ``(family, series)`` into ``ledger.PerfLedger.series``:
#: ``"value"`` is the family's headline metric, anything else an extras
#: key.  The newest round gates against the noise band of all previous
#: readings, the same sign-aware bound arithmetic as the pairwise gate —
#: so the trend gate catches a slide the pairwise compare never sees
#: (each round individually within tolerance of its predecessor).
LEDGER_TRENDS = {
    ("BENCH", "value"): "higher",
    ("BENCH", "vs_baseline"): "higher",
    ("BENCH", "kernel_parity_max_abs_diff"): "lower",
    ("MULTICHIP", "value"): "higher",
    ("MULTICHIP", "host_syncs_per_100_rounds"): "lower",
    ("MULTICHIP", "overlap_efficiency"): "higher",
    ("FLEET", "value"): "higher",
    ("FLEET", "scaling_1_to_2"): "higher",
}


def _band_bound(band_edge: float, direction: str, rtol: float,
                atol: float = 1e-9) -> float:
    """Sign-aware tolerance widening of a band edge (shared with the
    pairwise gate's inline arithmetic)."""
    if direction == "lower":
        return band_edge * (1.0 + rtol) + atol if band_edge >= 0 \
            else band_edge * (1.0 - rtol) + atol
    return band_edge * (1.0 - rtol) - atol if band_edge >= 0 \
        else band_edge * (1.0 + rtol) - atol


def trend_gate(ledger, rtol: float = 0.10, tail: int = 5) -> dict:
    """Cross-round regression gate over a ``PerfLedger``.

    For every declared trend series with >= 2 readings, the newest
    round's value must stay inside the noise band (``tail_band`` over
    the trailing ``tail`` previous readings) widened by ``rtol`` in the
    series' improvement direction.  A latest-round record with
    ``ok=false`` in any family regresses outright — a round that failed
    to produce its record must not pass on the strength of old numbers.
    Returns the comparison record (``rc`` 0/2), mirroring
    ``compare_runs``."""
    out: dict = {"root": ledger.root, "trends": {}, "regressions": [],
                 "families": ledger.families()}
    for family in ledger.families():
        rows = ledger.family_rows(family)
        if rows and not rows[-1]["ok"]:
            name = f"{family}:ok"
            out["trends"][name] = {
                "latest_round": rows[-1]["round"], "regressed": True,
                "reason": f"latest round r{rows[-1]['round']:02d} "
                          f"({rows[-1]['file']}) reports ok=false"}
            out["regressions"].append(name)
    for (family, key), direction in sorted(LEDGER_TRENDS.items()):
        pts = ledger.series(family, key)
        if len(pts) < 2:
            continue
        rounds = [r for r, _ in pts]
        values = [v for _, v in pts]
        band = tail_band(values[:-1], tail)
        latest_r, latest = rounds[-1], values[-1]
        regressed, why = False, None
        if direction == "lower":
            bound = _band_bound(band["max"], "lower", rtol)
            if math.isfinite(bound) and latest > bound:
                regressed = True
                why = (f"r{latest_r:02d} value {latest:.6g} above prior "
                       f"band max {band['max']:.6g} (+{rtol * 100:.0f}%)")
        else:
            bound = _band_bound(band["min"], "higher", rtol)
            if math.isfinite(bound) and latest < bound:
                regressed = True
                why = (f"r{latest_r:02d} value {latest:.6g} below prior "
                       f"band min {band['min']:.6g} (-{rtol * 100:.0f}%)")
        name = f"{family}:{key}"
        out["trends"][name] = {
            "direction": direction, "rounds": rounds, "values": values,
            "band": band, "latest_round": latest_r, "latest": latest,
            "regressed": regressed, "reason": why}
        if regressed:
            out["regressions"].append(name)
    out["rc"] = 2 if out["regressions"] else 0
    return out


def render_trend(gate: dict) -> str:
    lines = [f"== ledger trend gate: {gate['root']} "
             f"({', '.join(gate['families']) or 'no records'}) =="]
    for name, t in sorted(gate["trends"].items()):
        if "values" not in t:
            lines.append(f"  {name:<38} REGRESSED")
            lines.append(f"    ^ {t['reason']}")
            continue
        span = (f"r{t['rounds'][0]:02d}..r{t['latest_round']:02d} "
                f"({len(t['values'])} readings)")
        verdict = "REGRESSED" if t["regressed"] else "ok"
        lines.append(f"  {name:<38} {span:<26} "
                     f"latest {_fmt(t['latest']):>12}  {verdict}")
        if t.get("reason"):
            lines.append(f"    ^ {t['reason']}")
    if gate["regressions"]:
        lines.append("RESULT: TREND REGRESSION in "
                     + ", ".join(gate["regressions"]))
    else:
        lines.append("RESULT: no trend regression")
    return "\n".join(lines)


def run_trend(root: str, rtol: float = 0.10,
              json_out: bool = False) -> int:
    """CLI body for ``--ledger``: load, gate, print, return exit code."""
    from .ledger import load_ledger

    ledger = load_ledger(root)
    if not ledger.rows:
        print(f"no bench records found under {root}", file=sys.stderr)
        return 2
    gate = trend_gate(ledger, rtol=rtol)
    if json_out:
        print(json.dumps(gate))
    else:
        print(render_trend(gate))
    return int(gate["rc"])


#: Flat-memory soak gate defaults: the head/tail medians of a
#: soak window's ``process_rss_bytes`` series must agree within
#: ``SOAK_RSS_RTOL`` plus an absolute slack — allocator warmup and JIT
#: cache growth land in the slack; an unbounded leak does not.
SOAK_RSS_RTOL = 0.15
SOAK_RSS_SLACK_BYTES = 64 << 20
SOAK_MIN_SAMPLES = 8


def soak_memory_gate(run_dir: str, metric: str = "process_rss_bytes",
                     rtol: float = SOAK_RSS_RTOL,
                     slack: float = SOAK_RSS_SLACK_BYTES,
                     window: int = 4,
                     min_samples: int = SOAK_MIN_SAMPLES) -> dict:
    """Flat-memory trend check over one soak run's ``ResourceSampler``
    series (the "memory held flat" acceptance, made
    checkable).

    The series' trailing-``window`` median must stay within
    ``head_median * (1 + rtol) + slack`` of its leading-``window``
    median.  Multiple labeled series (one per replica/rank) gate
    independently — any replica leaking fails the run.  Too few samples
    is a SKIP (ok, flagged), not a pass pretending to be evidence."""
    run = load_run(run_dir)
    series: dict = {}
    for ev in run["events"]:
        if ev.get("event") != "metric" or ev.get("metric") != metric:
            continue
        v = ev.get("value")
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            continue
        who = str(ev.get("replica", ev.get("rank", "self")))
        series.setdefault(who, []).append(float(v))
    out: dict = {"run_dir": run_dir, "metric": metric, "rtol": rtol,
                 "slack_bytes": slack, "series": {}, "regressions": []}
    for who, vals in sorted(series.items()):
        if len(vals) < min_samples:
            out["series"][who] = {"samples": len(vals), "skipped": True,
                                  "reason": f"only {len(vals)} samples "
                                            f"(< {min_samples})"}
            continue
        head = tail_band(vals[:window], window)["median"]
        tail = tail_band(vals, window)["median"]
        bound = head * (1.0 + rtol) + slack
        regressed = tail > bound
        out["series"][who] = {
            "samples": len(vals), "skipped": False,
            "head_median": head, "tail_median": tail, "bound": bound,
            "growth_bytes": tail - head, "regressed": regressed}
        if regressed:
            out["regressions"].append(who)
    if not series:
        out["skipped"] = True
        out["reason"] = f"no {metric!r} samples in {run_dir} " \
                        "(sampler off or telemetry-off run)"
    out["rc"] = 2 if out["regressions"] else 0
    return out


def render_soak(gate: dict) -> str:
    lines = [f"== flat-memory soak gate: {gate['run_dir']} "
             f"({gate['metric']}) =="]
    if gate.get("skipped"):
        lines.append(f"SKIPPED: {gate['reason']}")
        return "\n".join(lines)
    for who, s in sorted(gate["series"].items()):
        if s.get("skipped"):
            lines.append(f"  {who:<16} SKIPPED ({s['reason']})")
            continue
        mb = 1.0 / (1 << 20)
        verdict = "LEAKING" if s["regressed"] else "flat"
        lines.append(
            f"  {who:<16} {s['samples']:>4} samples  "
            f"head {s['head_median'] * mb:8.1f}MiB -> "
            f"tail {s['tail_median'] * mb:8.1f}MiB "
            f"({s['growth_bytes'] * mb:+8.1f}MiB)  {verdict}")
    if gate["regressions"]:
        lines.append("RESULT: MEMORY NOT FLAT in "
                     + ", ".join(gate["regressions"]))
    else:
        lines.append("RESULT: memory held flat")
    return "\n".join(lines)


def run_soak(run_dir: str, rtol: float | None = None,
             json_out: bool = False) -> int:
    """CLI body for ``--soak``: gate, print, return exit code."""
    try:
        gate = soak_memory_gate(
            run_dir, rtol=SOAK_RSS_RTOL if rtol is None else rtol)
    except (ValueError, OSError) as e:
        print(str(e), file=sys.stderr)
        return 2
    if json_out:
        print(json.dumps(gate))
    else:
        print(render_soak(gate))
    return int(gate["rc"])


def run_compare(dir_a: str, dir_b: str, rtol: float = 0.05,
                json_out: bool = False, allow_mismatch: bool = False) -> int:
    """CLI body shared by ``report --compare`` and ``python -m
    dpgo_tpu.obs.regress``; prints and returns the exit code."""
    try:
        cmp = compare_runs(dir_a, dir_b, rtol=rtol,
                           allow_mismatch=allow_mismatch)
    except (ValueError, OSError) as e:
        print(str(e), file=sys.stderr)
        return 2
    if json_out:
        print(json.dumps(cmp))
    else:
        print(render_compare(cmp))
    return int(cmp["rc"])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dpgo_tpu_torch.obs.regress", description=__doc__)
    ap.add_argument("run_a", nargs="?")
    ap.add_argument("run_b", nargs="?")
    ap.add_argument("--rtol", type=float, default=None,
                    help="relative tolerance over the baseline band "
                         "(default 0.05 pairwise, 0.10 for --ledger)")
    ap.add_argument("--allow-mismatch", action="store_true",
                    help="compare despite fingerprint mismatches")
    ap.add_argument("--ledger", metavar="ROOT",
                    help="cross-round trend gate over the BENCH_r*/"
                         "MULTICHIP_r*/FLEET_r* records under ROOT "
                         "instead of a pairwise run compare")
    ap.add_argument("--soak", metavar="RUN_DIR",
                    help="flat-memory gate over one soak run's "
                         "ResourceSampler series (process_rss_bytes "
                         "head vs tail median; exit 2 on growth)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.soak is not None:
        if args.run_a or args.run_b:
            ap.error("--soak takes no extra run directories")
        return run_soak(args.soak, rtol=args.rtol, json_out=args.json)
    if args.ledger is not None:
        if args.run_a or args.run_b:
            ap.error("--ledger takes no run directories")
        return run_trend(args.ledger,
                         rtol=0.10 if args.rtol is None else args.rtol,
                         json_out=args.json)
    if not (args.run_a and args.run_b):
        ap.error("need two run directories (or --ledger ROOT)")
    return run_compare(args.run_a, args.run_b,
                       rtol=0.05 if args.rtol is None else args.rtol,
                       json_out=args.json,
                       allow_mismatch=args.allow_mismatch)


if __name__ == "__main__":
    sys.exit(main())

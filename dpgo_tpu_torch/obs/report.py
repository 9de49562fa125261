"""Human-readable run report CLI.

Usage::

    python -m dpgo_tpu_torch.obs.report <run_dir> [<run_dir>...] [--json]
    python -m dpgo_tpu_torch.obs.report --compare <run_a> <run_b> [--json]
    python -m dpgo_tpu_torch.obs.report --live <host>:<port> [--json]

``--live`` is the one mode that doesn't read artifacts: it scrapes a
running serve sidecar's ``/statusz`` endpoint
(``SolveServer(metrics_port=...)``) and renders queue depth, per-tenant
in-flight vs. quota, cache compile/hit tallies, last-batch occupancy,
and SLO burn rates while the server is still up.

Reads the artifacts a ``TelemetryRun`` persisted (``events.jsonl``,
``metrics.json``) and prints the run's story: event volume, per-iteration
cost/gradient-norm trajectory, GNC mu annealing, round latency, per-phase
wall-clock, communication volume, and — when the run carries ``span``
events — the fleet timeline: per-robot busy/wait breakdown, per-round
critical path, straggler ranking, and overlap efficiency.  Runs that hit
numerical-health anomalies (``obs.health``) get a "numerical health"
section and a pointer to the flight-recorder black box.  ``--json``
emits the same content machine-readably (one JSON document per run dir).
``--compare`` invokes the convergence regression gate (``obs.regress``):
exit 0 = no regression, 2 = regression or refused (mismatched
fingerprints).  Pure host-side formatting — no devices are touched, so
it runs anywhere the run directory is visible.

The PyTorch port's copy of ``dpgo_tpu.obs.report``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter as _TallyCounter

from .events import read_events_meta
from .run import EVENTS_FILE, META_FILE, METRICS_FILE
from .timeline import fleet_timeline_stats


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _trajectory_lines(events: list[dict], metric: str) -> list[str]:
    pts = [(ev.get("iteration", ev["seq"]), ev["value"]) for ev in events
           if ev.get("event") == "metric" and ev.get("metric") == metric
           and isinstance(ev.get("value"), (int, float))]
    if not pts:
        return []
    vals = [v for _, v in pts]
    head = (f"  {metric}: {len(pts)} points, first {_fmt(vals[0])}, "
            f"last {_fmt(vals[-1])}, min {_fmt(min(vals))}, "
            f"max {_fmt(max(vals))}")
    shown = pts if len(pts) <= 8 else pts[:4] + [None] + pts[-3:]
    rows = []
    for p in shown:
        rows.append("      ..." if p is None
                    else f"      iter {p[0]:>6}: {_fmt(p[1])}")
    return [head] + rows


def _histogram_summary(name: str, fam: dict) -> list[str]:
    out = []
    bounds = fam.get("buckets", [])
    for s in fam.get("series", []):
        labels = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
        n = s.get("count", 0)
        if not n:
            continue
        mean = s["sum"] / n
        # Approximate median from the cumulative buckets.
        cum, med = 0, "inf"
        for bound, c in zip(bounds, s["counts"]):
            cum += c
            if cum >= n / 2:
                med = _fmt(bound)
                break
        lab = f"{{{labels}}}" if labels else ""
        out.append(f"  {name}{lab}: n={n} mean={_fmt(mean)} p50<={med}")
    return out


def _health_lines(events: list[dict]) -> list[str]:
    """Render the numerical-health section: anomaly events (solver +
    per-robot), fleet-wide peer anomaly sightings, and black-box dumps."""
    anomalies = [ev for ev in events if ev.get("event") == "anomaly"]
    peer = [ev for ev in events if ev.get("event") == "peer_anomaly"]
    dumps = [ev for ev in events if ev.get("event") == "blackbox_dump"]
    if not (anomalies or peer or dumps):
        return []
    crit = sum(1 for ev in anomalies if ev.get("severity") == "critical")
    lines = [f"numerical health: {len(anomalies)} anomalies"
             + (f" ({crit} critical)" if crit else "")]
    for ev in anomalies[:10]:
        where = f" robot {ev['robot']}" if "robot" in ev else ""
        it = f" iter {ev['iteration']}" if "iteration" in ev else ""
        lines.append(f"  [{ev.get('severity')}]{it}{where} "
                     f"{ev.get('kind')} (stage {ev.get('stage', 0)})")
    if len(anomalies) > 10:
        lines.append(f"  ... {len(anomalies) - 10} more")
    if peer:
        tally = _TallyCounter(ev.get("peer") for ev in peer)
        lines.append("  fleet: anomalies seen from "
                     + ", ".join(f"robot {p} x{n}"
                                 for p, n in sorted(tally.items())))
    for ev in dumps:
        lines.append(f"  blackbox: {ev.get('path')} (reason "
                     f"{ev.get('reason')}, {ev.get('rounds_recorded')} "
                     f"rounds, {ev.get('snapshots')} snapshots)")
    return lines


def serving_stats(events: list[dict]) -> dict | None:
    """Per-tenant serving SLOs from the serve plane's event schema
    (``serve_request`` / ``serve_batch`` / ``serve_shed`` — the same
    records ``bench_serving.py`` writes), shared by the text report, the
    ``--json`` payload, and the bench's assertions.

    Per tenant: request count, QPS over the tenant's request window,
    queue-wait p50, and solve-latency p50/p99 (exact percentiles from the
    per-request events, not histogram-bucket approximations).  Fleet-wide:
    batch count, mean batch occupancy/size, shed tallies by tenant and
    reason, and SLO burn alerts (``slo_burn`` anomalies).

    A run whose serve plane saw no completed request (server stood up,
    everything shed or nothing arrived) reports ``no_traffic=True`` with
    empty tenant stats — there is no submit->complete window to divide
    by, and the report renders an explicit "no traffic" line instead of
    exploding."""
    reqs = [ev for ev in events if ev.get("event") == "serve_request"]
    batches = [ev for ev in events if ev.get("event") == "serve_batch"]
    sheds = [ev for ev in events if ev.get("event") == "serve_shed"]
    serve_seen = any(ev.get("phase") == "serve" for ev in events)
    if not (reqs or batches or sheds or serve_seen):
        return None

    def _pct(vals, q):
        if not vals:
            return None
        vals = sorted(vals)
        k = min(len(vals) - 1, max(0, int(round(q / 100.0 * (len(vals) - 1)))))
        return vals[k]

    tenants: dict = {}
    for ev in reqs:
        tenants.setdefault(ev.get("tenant", "?"), []).append(ev)
    out_t = {}
    for tenant, evs in sorted(tenants.items()):
        lats = [ev["latency_s"] for ev in evs
                if isinstance(ev.get("latency_s"), (int, float))]
        waits = [ev["queue_wait_s"] for ev in evs
                 if isinstance(ev.get("queue_wait_s"), (int, float))]
        # Completion events of one batch land within microseconds of each
        # other, so the serving window runs from the first request's
        # SUBMIT (its completion stamp minus its latency) to the last
        # completion.
        first_submit = evs[0]["t_mono"] - (evs[0].get("latency_s") or 0.0)
        window = evs[-1]["t_mono"] - first_submit
        out_t[tenant] = {
            "requests": len(evs),
            "qps": len(evs) / window if window > 0 else None,
            "queue_wait_p50_s": _pct(waits, 50),
            "latency_p50_s": _pct(lats, 50),
            "latency_p99_s": _pct(lats, 99),
        }
    occ = [ev["occupancy"] for ev in batches
           if isinstance(ev.get("occupancy"), (int, float))]
    sizes = [ev["size"] for ev in batches
             if isinstance(ev.get("size"), (int, float))]
    shed_tally = dict(_TallyCounter(
        (ev.get("tenant", "?"), ev.get("reason", "?")) for ev in sheds))
    # SLO burn alerts: the serve plane's slo_burn anomalies + recoveries.
    burns = [ev for ev in events if ev.get("event") == "anomaly"
             and ev.get("kind") == "slo_burn"]
    slo = None
    if burns:
        slo = {}
        for ev in burns:
            row = slo.setdefault(
                ev.get("tenant", "?"),
                {"alerts": 0, "max_burn": 0.0, "worst_severity": None,
                 "slos": set()})
            row["alerts"] += 1
            rate = ev.get("burn_rate")
            if isinstance(rate, (int, float)):
                row["max_burn"] = max(row["max_burn"], float(rate))
            if ev.get("severity") == "critical" or \
                    row["worst_severity"] is None:
                row["worst_severity"] = ev.get("severity")
            row["slos"].add(ev.get("slo", "?"))
        for row in slo.values():
            row["slos"] = sorted(row["slos"])
    return {
        "no_traffic": not reqs,
        "tenants": out_t,
        "batches": {
            "count": len(batches),
            "mean_occupancy": sum(occ) / len(occ) if occ else None,
            "mean_size": sum(sizes) / len(sizes) if sizes else None,
        },
        "shed": [{"tenant": t, "reason": r, "count": n}
                 for (t, r), n in sorted(shed_tally.items())],
        "slo": slo,
    }


def _serving_lines(stats: dict | None) -> list[str]:
    """Render the serving section (serve-plane events present)."""
    if not stats:
        return []
    lines = ["serving:"]
    if stats.get("no_traffic"):
        lines.append("  no completed requests (no traffic)")
    for tenant, row in stats["tenants"].items():
        parts = [f"{row['requests']} requests"]
        if row["qps"] is not None:
            parts.append(f"{row['qps']:.2f} req/s")
        if row["queue_wait_p50_s"] is not None:
            parts.append(f"queue wait p50 {row['queue_wait_p50_s'] * 1e3:.1f}ms")
        if row["latency_p50_s"] is not None:
            parts.append(f"latency p50 {row['latency_p50_s']:.3f}s"
                         + (f" / p99 {row['latency_p99_s']:.3f}s"
                            if row["latency_p99_s"] is not None else ""))
        lines.append(f"  tenant {tenant}: " + ", ".join(parts))
    b = stats["batches"]
    if b["count"] and b["mean_occupancy"] is not None:
        lines.append(
            f"  batches: {b['count']} dispatched, mean occupancy "
            f"{b['mean_occupancy'] * 100:.0f}%, mean size "
            f"{b['mean_size']:.1f}")
    for s in stats["shed"]:
        lines.append(f"  shed: tenant {s['tenant']} x{s['count']} "
                     f"({s['reason']})")
    for tenant, row in sorted((stats.get("slo") or {}).items()):
        lines.append(
            f"  slo burn: tenant {tenant} {row['alerts']} alert(s) "
            f"[{row['worst_severity']}] on {'/'.join(row['slos'])}, "
            f"max burn {row['max_burn']:.1f}x")
    return lines


def sharded_stats(events: list[dict]) -> dict | None:
    """Mesh-path facts from the event stream (``solve_rbcd_sharded`` /
    ``bench_sharded.py`` schemas), shared by the text report, ``--json``,
    and the bench's assertions: mesh layout + exchange backend + halo
    overlap flag (``sharded_solve`` setup events), modeled vs measured
    interconnect bytes per round (``sharded_comm_bytes_measured`` metric,
    measured = parsed from the compiled program's collectives), halo
    overlap efficiency (``sharded_overlap_efficiency`` metric, 1 -
    t_overlap/t_lockstep), the verdict sync rate, the sharded GN-CG
    tail summary (``gn_tail`` events with ``sharded=True``), and the
    pod-scale resilience story (``mesh_checkpoint`` / ``mesh_fault`` /
    ``mesh_rewind`` events from ``parallel.resilience``)."""
    setup = [ev for ev in events if ev.get("event") == "sharded_solve"]
    overlap = [ev for ev in events if ev.get("event") == "metric"
               and ev.get("metric") == "sharded_overlap_efficiency"]
    comm = [ev for ev in events if ev.get("event") == "metric"
            and ev.get("metric") == "sharded_comm_bytes_measured"]
    tails = [ev for ev in events if ev.get("event") == "gn_tail"
             and ev.get("sharded")]
    checkpoints = [ev for ev in events
                   if ev.get("event") == "mesh_checkpoint"]
    faults = [ev for ev in events if ev.get("event") == "mesh_fault"]
    rewinds = [ev for ev in events if ev.get("event") == "mesh_rewind"]
    if not (setup or overlap or comm or tails or checkpoints or faults
            or rewinds):
        return None
    out: dict = {"solves": [], "gn_tails": []}
    syncs = [ev for ev in events if ev.get("event") == "metric"
             and ev.get("metric") == "host_syncs_per_100_rounds"]
    for ev in setup:
        out["solves"].append({
            "mesh_size": ev.get("mesh_size"),
            "mesh_axes": ev.get("mesh_axes"),
            "agents_per_shard": ev.get("agents_per_shard"),
            "exchange": ev.get("exchange"),
            "overlap": ev.get("overlap"),
            "verdict_every": ev.get("verdict_every"),
            "comm_bytes_per_round": ev.get("comm_bytes_per_round"),
        })
    if syncs:
        out["host_syncs_per_100_rounds"] = syncs[-1].get("value")
    if overlap:
        ev = overlap[-1]
        out["overlap"] = {"efficiency": ev.get("value"),
                          "overlap_rounds_per_s": ev.get("overlap_rounds_per_s"),
                          "lockstep_rounds_per_s": ev.get("lockstep_rounds_per_s")}
    if comm:
        ev = comm[-1]
        out["comm_measured"] = {"measured": ev.get("value"),
                                "modeled": ev.get("modeled")}
    for ev in tails:
        out["gn_tails"].append({
            "terminated_by": ev.get("terminated_by"),
            "outer_iterations": ev.get("outer_iterations"),
            "cg_iterations": ev.get("cg_iterations"),
            "cost": ev.get("cost"), "grad_norm": ev.get("grad_norm")})
    if checkpoints or rewinds or faults:
        overhead = [ev for ev in events if ev.get("event") == "metric"
                    and ev.get("metric") == "mesh_recovery_overhead_s"]
        out["resilience"] = {
            "checkpoints": len(checkpoints),
            "last_checkpoint_iteration":
                checkpoints[-1].get("iteration") if checkpoints else None,
            "faults": [{"kind": ev.get("kind"),
                        "phase": ev.get("fault_phase"),
                        "device": ev.get("device")} for ev in faults],
            "rewinds": [{"kind": ev.get("kind"),
                         "mesh_from": ev.get("mesh_from"),
                         "mesh_to": ev.get("mesh_to"),
                         "resume_iteration": ev.get("resume_iteration"),
                         "cold": ev.get("cold")} for ev in rewinds],
            "recovery_overhead_s":
                overhead[-1].get("value") if overhead else None,
        }
    return out


def _sharded_lines(stats: dict | None) -> list[str]:
    """Render the sharded section (mesh-path events present)."""
    if not stats:
        return []
    lines = ["sharded:"]
    for s in stats["solves"]:
        axes = "x".join(str(a) for a in (s.get("mesh_axes") or []))
        parts = [f"mesh {s['mesh_size']} devices ({axes})",
                 f"{s['agents_per_shard']} agents/shard",
                 f"exchange {s['exchange']}",
                 f"halo overlap {'on' if s.get('overlap') else 'off'}"]
        if s.get("verdict_every"):
            parts.append(f"verdict loop K={s['verdict_every']}")
        lines.append("  " + ", ".join(parts))
        if s.get("comm_bytes_per_round") is not None:
            lines.append("  interconnect (modeled): "
                         f"{_fmt_bytes(s['comm_bytes_per_round'])}/round"
                         "/device")
    cm = stats.get("comm_measured")
    if cm and cm.get("measured") is not None:
        ratio = ""
        if cm.get("modeled"):
            ratio = f" ({cm['measured'] / cm['modeled']:.2f}x model)"
        lines.append(f"  interconnect (compiled collectives): "
                     f"{_fmt_bytes(cm['measured'])}/round/device{ratio}")
    if stats.get("host_syncs_per_100_rounds") is not None:
        lines.append("  verdict sync rate: "
                     f"{_fmt(stats['host_syncs_per_100_rounds'])} host "
                     "fetches / 100 rounds")
    ov = stats.get("overlap")
    if ov and ov.get("efficiency") is not None:
        detail = ""
        if ov.get("overlap_rounds_per_s") and ov.get("lockstep_rounds_per_s"):
            detail = (f" ({ov['overlap_rounds_per_s']:.1f} vs "
                      f"{ov['lockstep_rounds_per_s']:.1f} rounds/s)")
        lines.append(
            f"  halo overlap efficiency: {ov['efficiency'] * 100:.1f}%"
            + detail)
        if ov["efficiency"] < 0:
            lines.append(
                "  WARNING: overlap not paying (negative efficiency — "
                "gate it off with overlap=\"auto\" or profile with "
                "devprof)")
    for t in stats["gn_tails"]:
        lines.append(
            f"  gn tail: {t['terminated_by']} after "
            f"{t['outer_iterations']} outer / {t['cg_iterations']} CG "
            f"iters, cost {_fmt(t.get('cost'))}, "
            f"gn {_fmt(t.get('grad_norm'))}")
    rz = stats.get("resilience")
    if rz:
        head = f"  resilience: {rz['checkpoints']} checkpoint(s)"
        if rz.get("last_checkpoint_iteration") is not None:
            head += f" (last at round {rz['last_checkpoint_iteration']})"
        if rz.get("recovery_overhead_s") is not None:
            head += f", recovery overhead {rz['recovery_overhead_s']:.2f}s"
        lines.append(head)
        for f in rz["faults"]:
            dev = f" device {f['device']}" if f.get("device") is not None \
                else ""
            lines.append(f"  mesh fault: {f['kind']} in phase "
                         f"{f['phase']}{dev}")
        for r in rz["rewinds"]:
            dest = "cold restart" if r.get("cold") \
                else f"round {r['resume_iteration']}"
            lines.append(
                f"  rewind [{r['kind']}]: mesh {r['mesh_from']} -> "
                f"{r['mesh_to']} devices, resumed from {dest}")
    return lines


def devprof_stats(events: list[dict]) -> dict | None:
    """Device-time attribution facts: ``devprof``'s
    ``device_attribution`` windows (compute/collective/idle split +
    measured overlap efficiency), the adaptive gate's
    ``overlap_decision`` records, and the solver planes'
    ``compile_profile`` rooflines.  Serve-plane compiles keep rendering
    in the fleet section (``fleet_serve_stats``); this section owns
    ``phase in ("solve", "sharded")``."""
    attrs = [ev for ev in events
             if ev.get("event") == "device_attribution"]
    decisions = [ev for ev in events
                 if ev.get("event") == "overlap_decision"]
    compiles = [ev for ev in events if ev.get("event") == "compile_profile"
                and ev.get("phase") in ("solve", "sharded")]
    errors = [ev for ev in events if ev.get("event") == "profiler_error"
              and ev.get("phase") in ("solve", "sharded")]
    if not (attrs or decisions or compiles):
        return None
    out: dict = {"windows": [], "decisions": [], "compiles": [],
                 "profiler_errors": len(errors)}
    for ev in attrs:
        out["windows"].append({k: ev.get(k) for k in (
            "label", "phase", "lanes", "num_rounds", "window_s",
            "compute_s", "collective_s", "idle_s", "per_round",
            "collective_hidden_s", "overlap_efficiency_measured",
            "top_ops", "trace_files", "profile_dir")})
    for ev in decisions:
        out["decisions"].append({k: ev.get(k) for k in (
            "overlap", "efficiency", "threshold", "reason", "mesh_size",
            "exchange", "calib_rounds",
            "lockstep_seconds", "overlapped_seconds",
            "lockstep_rounds_per_s", "overlapped_rounds_per_s",
            "lockstep_overlap_efficiency_measured",
            "overlapped_overlap_efficiency_measured",
            "lockstep_collective_s_per_round",
            "overlapped_collective_s_per_round")})
    for ev in compiles:
        out["compiles"].append({k: ev.get(k) for k in (
            "label", "phase", "key", "static", "lower_s", "compile_s",
            "total_s", "flops", "bytes_accessed", "bytes_per_flop",
            "temp_bytes")})
    return out


def _devprof_lines(stats: dict | None) -> list[str]:
    """Render the device-profile section (devprof events present)."""
    if not stats:
        return []
    lines = ["device profile:"]
    for w in stats["windows"]:
        busy = (w.get("compute_s") or 0.0) + (w.get("collective_s") or 0.0)
        total = busy + (w.get("idle_s") or 0.0)
        pct = (lambda v: f"{100.0 * v / total:.0f}%") if total > 0 \
            else (lambda v: "-")
        lines.append(
            f"  window [{w.get('label')}] ({w.get('phase')}): "
            f"{w.get('lanes')} lanes x {_fmt(w.get('window_s'))}s, "
            f"{w.get('num_rounds')} rounds — compute "
            f"{pct(w.get('compute_s') or 0.0)}, collective "
            f"{pct(w.get('collective_s') or 0.0)}, idle "
            f"{pct(w.get('idle_s') or 0.0)}")
        eff = w.get("overlap_efficiency_measured")
        if eff is not None:
            lines.append(
                f"    measured overlap: {eff * 100:.1f}% of collective "
                f"time hidden behind compute "
                f"({_fmt(w.get('collective_hidden_s'))}s of "
                f"{_fmt(w.get('collective_s'))}s)")
        for op in (w.get("top_ops") or [])[:3]:
            lines.append(
                f"    top op: {op.get('op')} [{op.get('kind')}] "
                f"{_fmt(op.get('total_s'))}s x{op.get('count')}")
    for d in stats["decisions"]:
        verdict = "ON" if d.get("overlap") else "OFF"
        if d.get("reason"):
            lines.append(f"  overlap gate: {verdict} ({d['reason']})")
            continue
        lines.append(
            f"  overlap gate: {verdict} — A/B efficiency "
            f"{(d.get('efficiency') or 0.0) * 100:.1f}% vs threshold "
            f"{(d.get('threshold') or 0.0) * 100:.0f}% "
            f"({_fmt(d.get('overlapped_rounds_per_s'))} vs "
            f"{_fmt(d.get('lockstep_rounds_per_s'))} rounds/s over "
            f"{d.get('calib_rounds')} calib rounds)")
        for arm in ("lockstep", "overlapped"):
            m = d.get(f"{arm}_overlap_efficiency_measured")
            if m is not None:
                lines.append(
                    f"    {arm} arm: measured overlap {m * 100:.1f}%, "
                    f"collective "
                    f"{_fmt(d.get(f'{arm}_collective_s_per_round'))}s"
                    "/round")
    for c in stats["compiles"]:
        static = ""
        if c.get("static"):
            static = " {" + ", ".join(
                f"{k}={v}" for k, v in sorted(c["static"].items())) + "}"
        roof = ""
        if c.get("bytes_per_flop") is not None:
            roof = f", {c['bytes_per_flop']:.2f} bytes/flop"
        flops = ""
        if c.get("flops") is not None:
            flops = f", {c['flops']:.3g} flops"
        lines.append(
            f"  compile [{c.get('label')}]{static} ({c.get('phase')}): "
            f"{_fmt(c.get('total_s'))}s{flops}{roof}")
    if stats.get("profiler_errors"):
        lines.append(f"  profiler errors: {stats['profiler_errors']} "
                     "(window(s) degraded, solve unaffected)")
    return lines


def cert_stats(events: list[dict]) -> dict | None:
    """Certificate-decision tallies: ACCEPT / FAIL /
    REFUSE counts over the run's ``certificate`` events, by source, plus
    the host-f64 REFUSE-band fallback wall — the denominator data for
    the f32 ACCEPT-band sweep."""
    evs = [ev for ev in events if ev.get("event") == "certificate"]
    if not evs:
        return None
    tally = {"accept": 0, "fail": 0, "refuse": 0}
    sources: dict = {}
    f64_s = 0.0
    for ev in evs:
        status = "accept" if ev.get("certified") else \
            ("fail" if ev.get("decidable") else "refuse")
        tally[status] += 1
        src = ev.get("source") or \
            ("certify_sharded" if ev.get("sharded") else "device_epilogue")
        sources[src] = sources.get(src, 0) + 1
        if isinstance(ev.get("f64_fallback_s"), (int, float)):
            f64_s += ev["f64_fallback_s"]
    return {"tally": tally, "sources": sources, "total": len(evs),
            "f64_fallback_s": f64_s}


def _cert_lines(stats: dict | None) -> list[str]:
    if not stats:
        return []
    t = stats["tally"]
    line = (f"  certificates: {t['accept']} accept / {t['fail']} fail / "
            f"{t['refuse']} refuse ("
            + ", ".join(f"{k} x{n}"
                        for k, n in sorted(stats["sources"].items()))
            + ")")
    lines = [line]
    if stats["f64_fallback_s"]:
        lines.append(f"  f64 fallback: {stats['f64_fallback_s']:.3f}s "
                     "wall in host eigensolves (REFUSE band)")
    return lines


def render_statusz(status: dict) -> str:
    """Human rendering of a live ``/statusz`` payload (the JSON
    ``serve.statusz.MetricsSidecar`` serves and ``SolveServer.status()``
    produces) — the ``--live`` mode's output."""
    lines = ["== live server status =="]
    lines.append(
        f"uptime {status.get('uptime_s', 0.0):.1f}s"
        + (", CLOSED" if status.get("closed") else ""))
    lines.append(
        f"queue: {status.get('queue_depth', 0)}/{status.get('max_queue', '?')}"
        f" pending, max batch {status.get('max_batch', '?')}, "
        f"quantum {status.get('quantum', '?')}")
    lines.append(
        f"lifetime: {status.get('requests_served', 0)} served / "
        f"{status.get('requests_shed', 0)} shed over "
        f"{status.get('batches_dispatched', 0)} batches")
    for tenant, row in (status.get("tenants") or {}).items():
        quota = row.get("quota")
        lines.append(f"  tenant {tenant}: {row.get('in_flight', 0)} in flight"
                     + (f" / quota {quota}" if quota is not None else ""))
    lb = status.get("last_batch")
    if lb:
        lines.append(
            f"last batch: {lb.get('size')}/{lb.get('batch')} slots "
            f"({(lb.get('occupancy') or 0) * 100:.0f}% occupancy), "
            f"{lb.get('rounds')} rounds in {lb.get('duration_s', 0):.3f}s")
    cache = status.get("cache")
    if cache:
        lines.append(
            f"executable cache: {cache.get('entries', 0)} entries, "
            f"{cache.get('compiles', 0)} compiles, "
            f"{cache.get('hits', 0)} hits")
    for tenant, row in (status.get("slo") or {}).items():
        level = row.get("level")
        lines.append(
            f"  slo {tenant}: latency burn {row.get('latency_burn', 0):.2f}x,"
            f" shed burn {row.get('shed_burn', 0):.2f}x"
            f" ({row.get('requests', 0)} req / {row.get('slow', 0)} slow / "
            f"{row.get('shed', 0)} shed in {row.get('window_s', 0):.0f}s)"
            + (f" ALERT {level}" if level else ""))
    return "\n".join(lines)


def render_fleet_statusz(payload: dict) -> str:
    """Human rendering of a fleet-level ``/statusz`` payload (the JSON
    ``obs.fleetobs.FleetSidecar`` serves): one line per replica with
    unreachable/dead replicas MARKED — a partial fleet is still a
    report, never an error."""
    lines = ["== live fleet status =="]
    replicas = payload.get("replicas") or {}
    up = sum(1 for e in replicas.values() if e.get("reachable"))
    lines.append(f"replicas: {up}/{len(replicas)} reachable")
    for rid, entry in sorted(replicas.items()):
        st = entry.get("status") or {}
        if not entry.get("reachable"):
            why = entry.get("error") or (
                "closed" if st.get("closed") else "no status")
            lines.append(f"  replica {rid}: ** UNREACHABLE ** ({why})")
            continue
        bits = [f"queue {st.get('queue_depth', 0)}"]
        if st.get("draining"):
            bits.append("DRAINING")
        if not st.get("accepting", True):
            bits.append("not accepting")
        if "heartbeat_misses" in st and st["heartbeat_misses"]:
            bits.append(f"{st['heartbeat_misses']} missed heartbeats")
        bits.append(f"{st.get('requests_served', 0)} served")
        lines.append(f"  replica {rid}: " + ", ".join(str(b)
                                                      for b in bits))
    fleet = payload.get("fleet") or {}
    for k in ("error",):
        if fleet.get(k):
            lines.append(f"  fleet {k}: {fleet[k]}")
    return "\n".join(lines)


def live_report(target: str, json_out: bool = False, timeout: float = 5.0,
                out=None, fleet: bool = False) -> int:
    """``--live HOST:PORT``: scrape a running server's ``/statusz``
    sidecar and render it.  rc 0 on success, 2 on unreachable/garbage
    (same contract as the run-dir error paths).

    With ``fleet=True`` (or a payload that is recognizably fleet-level)
    the target is an aggregated ``FleetSidecar`` endpoint: replicas that
    died or dropped mid-scrape render MARKED inside a partial fleet
    view with rc 0 — only the aggregate endpoint itself being
    unreachable is rc 2."""
    import urllib.error
    import urllib.request

    out = out or sys.stdout
    if "://" not in target:
        target = f"http://{target}"
    url = target.rstrip("/") + "/statusz"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            status = json.load(resp)
    except (urllib.error.URLError, OSError, ValueError) as e:
        # An HTTPError carries the open response body: close it on the
        # error path too, the success path's `with` never ran
        # (leakcheck-enforced contract).
        if hasattr(e, "close"):
            e.close()
        print(f"cannot scrape {url}: {e}", file=sys.stderr)
        return 2
    is_fleet = fleet or ("replicas" in status and "fleet" in status)
    if json_out:
        print(json.dumps(status), file=out)
    elif is_fleet:
        print(render_fleet_statusz(status), file=out)
    else:
        print(render_statusz(status), file=out)
    return 0


def _fleet_lines(stats: dict | None) -> list[str]:
    """Render the fleet-timeline section (tracing spans present)."""
    if not stats:
        return []
    lines = [f"fleet timeline: {stats['num_spans']} spans over "
             f"{stats['window_s']:.2f}s, "
             f"{stats['num_flow_links']} cross-robot frame links"]
    for r, row in sorted(stats["robots"].items()):
        who = "bus" if int(r) < 0 else f"robot {r}"
        parts = [f"busy {row['busy_s']:.3f}s"]
        if row["wait_s"]:
            parts.append(f"wait {row['wait_s']:.3f}s")
        if row["wire_s"]:
            parts.append(f"wire {row['wire_s']:.3f}s")
        if row["iterations"]:
            parts.append(f"{row['iterations']} iterates @ "
                         f"{(row['mean_iterate_s'] or 0) * 1e3:.2f}ms")
        if row["overlap_efficiency"] is not None:
            parts.append(
                f"overlap eff {row['overlap_efficiency'] * 100:.0f}%")
        lines.append(f"  {who}: " + ", ".join(parts))
    rc = stats.get("round_critical_path")
    if rc:
        crit = ", ".join(f"robot {r} x{n}"
                         for r, n in rc["critical_path_counts"].items())
        lines.append(
            f"  critical path over {rc['rounds']} rounds: makespan "
            f"mean {rc['mean_makespan_s'] * 1e3:.2f}ms / p95 "
            f"{rc['p95_makespan_s'] * 1e3:.2f}ms; ends on {crit}")
    strag = stats.get("straggler_ranking")
    if strag:
        lines.append("  stragglers (mean iterate, slowest first): "
                     + ", ".join(f"robot {s['robot']} "
                                 f"{s['mean_iterate_s'] * 1e3:.2f}ms"
                                 for s in strag[:5]))
    return lines


def fleet_serve_stats(events: list[dict]) -> dict | None:
    """Fleet-of-replicas serving stats from ``serve.fleet``'s event
    schema (``replica_spawn``/``replica_death``/``fleet_scale``/
    ``session_migrated`` plus the AOT disk tier's ``compile_profile``/
    ``aot_entry_quarantined``/``aot_store_failed``), shared by the text
    report and the ``--json`` payload (``out["fleet"]``).

    Distinct from :func:`~dpgo_tpu_torch.obs.timeline.fleet_timeline_stats`,
    which reconstructs the *robot* fleet's span timeline — this section
    is about the *replica* fleet: lifecycle churn, live migrations by
    kind, autoscaler decisions, and the persistent-cache disk-hit vs.
    compile split that proves a warm restart skipped XLA."""
    spawns = [ev for ev in events if ev.get("event") == "replica_spawn"]
    deaths = [ev for ev in events if ev.get("event") == "replica_death"]
    scales = [ev for ev in events if ev.get("event") == "fleet_scale"]
    migs = [ev for ev in events if ev.get("event") == "session_migrated"]
    quarantined = [ev for ev in events
                   if ev.get("event") == "aot_entry_quarantined"]
    store_fails = [ev for ev in events
                   if ev.get("event") == "aot_store_failed"]
    fleet_seen = any(ev.get("phase") == "fleet" for ev in events)
    if not (fleet_seen or quarantined or store_fails):
        return None
    profiles = [ev for ev in events if ev.get("event") == "compile_profile"]
    disk_hits = [ev for ev in profiles if ev.get("disk_hit")]
    compiles = [ev for ev in profiles if not ev.get("disk_hit")]
    cold = [ev for ev in events if ev.get("event") == "metric"
            and ev.get("metric") == "serve_cold_start_seconds"]
    out: dict = {
        "replicas": {
            "spawned": len(spawns),
            "spawn_reasons": dict(_TallyCounter(
                ev.get("reason", "?") for ev in spawns)),
            "deaths": len(deaths),
            "pool_end": ([ev.get("pool") for ev in spawns + deaths
                          + scales] or [None])[-1],
        },
        "migrations": {
            "count": len(migs),
            "by_kind": dict(_TallyCounter(
                ev.get("kind", "?") for ev in migs)),
            "failed": sum(1 for ev in migs if not ev.get("ok")),
            "sessions": sorted({ev["session"] for ev in migs
                                if ev.get("session")}),
        },
        "scale": {
            "events": len(scales),
            "by_direction": dict(_TallyCounter(
                ev.get("direction", "?") for ev in scales)),
            "last_burn": scales[-1].get("burn") if scales else None,
        },
        "aot": {
            "disk_hits": len(disk_hits),
            "compiles": len(compiles),
            "quarantined": len(quarantined),
            "store_failures": len(store_fails),
        } if (profiles or quarantined or store_fails) else None,
        "cold_start": [
            {"arm": ev.get("arm", "?"),
             "first_solve_s": ev.get("value"),
             "compile_seconds_total": ev.get("compile_seconds_total"),
             "disk_hits": ev.get("disk_hits")}
            for ev in cold] or None,
    }
    return out


def _fleet_serve_lines(stats: dict | None) -> list[str]:
    """Render the replica-fleet section (fleet-phase events present)."""
    if not stats:
        return []
    rep = stats["replicas"]
    reasons = ", ".join(f"{k} {n}" for k, n
                        in sorted(rep["spawn_reasons"].items()))
    lines = [f"fleet: {rep['spawned']} replicas spawned"
             + (f" ({reasons})" if reasons else "")
             + f", {rep['deaths']} deaths"
             + (f", pool {rep['pool_end']} at end"
                if rep["pool_end"] is not None else "")]
    mig = stats["migrations"]
    if mig["count"]:
        kinds = ", ".join(f"{k} {n}" for k, n
                          in sorted(mig["by_kind"].items()))
        line = f"  migrations: {mig['count']} ({kinds})"
        if mig["failed"]:
            line += f", {mig['failed']} FAILED"
        if mig["sessions"]:
            line += " — sessions " + ", ".join(mig["sessions"][:6])
            if len(mig["sessions"]) > 6:
                line += f" (+{len(mig['sessions']) - 6} more)"
        lines.append(line)
    sc = stats["scale"]
    if sc["events"]:
        dirs = ", ".join(f"{k} {n}" for k, n
                         in sorted(sc["by_direction"].items()))
        line = f"  autoscale: {sc['events']} decisions ({dirs})"
        if sc["last_burn"] is not None:
            line += f", last burn {sc['last_burn']:.3g}"
        lines.append(line)
    aot = stats["aot"]
    if aot:
        line = (f"  aot cache: {aot['disk_hits']} disk hits / "
                f"{aot['compiles']} compiles")
        if aot["quarantined"]:
            line += f", {aot['quarantined']} QUARANTINED"
        if aot["store_failures"]:
            line += f", {aot['store_failures']} store failures"
        lines.append(line)
    for row in stats["cold_start"] or []:
        parts = []
        if row["first_solve_s"] is not None:
            parts.append(f"first solve {row['first_solve_s']:.3f}s")
        if row["compile_seconds_total"] is not None:
            parts.append(f"compile {row['compile_seconds_total']:.3f}s")
        if row["disk_hits"] is not None:
            parts.append(f"{row['disk_hits']} disk hits")
        lines.append(f"  cold start [{row['arm']}]: " + ", ".join(parts))
    return lines


def render_report(run_dir: str) -> str:
    lines = [f"== telemetry report: {run_dir} =="]
    meta_path = os.path.join(run_dir, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        lines.append(f"run id: {meta.get('run')}")

    ev_path = os.path.join(run_dir, EVENTS_FILE)
    events, truncated = read_events_meta(ev_path) \
        if os.path.exists(ev_path) else ([], False)
    if truncated:
        lines.append("WARNING: event stream ends mid-line (writer killed "
                     "mid-write?) — final event dropped")
    if events:
        dur = events[-1]["t_mono"] - events[0]["t_mono"]
        lines.append(f"events: {len(events)} over {dur:.2f}s")
        tally = _TallyCounter(ev.get("event", "?") for ev in events)
        kinds = ", ".join(f"{k} x{n}" for k, n in sorted(tally.items()))
        lines.append(f"  kinds: {kinds}")

        for ev in events:
            if ev.get("event") == "solve_end":
                verdict = ""
                if ev.get("verdict_every"):
                    v = ev.get("verdict") or {}
                    verdict = (f" [verdict loop K={ev['verdict_every']}"
                               + (f", anomaly={v['anomaly']}"
                                  if v.get("anomaly") else "") + "]")
                lines.append(
                    f"solve: {ev.get('iterations')} iterations, "
                    f"terminated by {ev.get('terminated_by')} "
                    f"in {_fmt(ev.get('duration_s'))}s" + verdict)
        # The readback-kill measurement (one metric event per solve).
        for ev in events:
            if ev.get("event") == "metric" \
                    and ev.get("metric") == "host_syncs_per_100_rounds":
                lines.append(
                    f"host syncs: {_fmt(ev.get('value'))} per 100 rounds "
                    f"({ev.get('fetches')} fetches / "
                    f"{ev.get('rounds')} rounds)")

        lines.append("trajectories:")
        metric_names = sorted({ev.get("metric") for ev in events
                               if ev.get("event") == "metric"
                               and ev.get("metric")})
        any_traj = False
        # Convergence signals first, everything else after.
        front = [m for m in ("solver_cost", "solver_grad_norm", "gnc_mu",
                             "gnc_inlier_fraction") if m in metric_names]
        for m in front + [m for m in metric_names if m not in front]:
            t = _trajectory_lines(events, m)
            any_traj = any_traj or bool(t)
            lines.extend(t)
        if not any_traj:
            lines.append("  (no metric events)")

        # Config fingerprint (run_summary channel="config" events, merged
        # in stream order — what report --compare keys on).
        fp: dict = {}
        for ev in events:
            if ev.get("event") == "run_summary" \
                    and ev.get("channel") == "config":
                fp.update(ev.get("fingerprint") or {})
        if fp:
            lines.append("config fingerprint: "
                         + ", ".join(f"{k}={fp[k]}" for k in sorted(fp)))

        # Network health: the comms layer's terminal run_summary events
        # (one per channel, plus the bus's aggregate) and peer-loss story.
        summaries = [ev for ev in events if ev.get("event") == "run_summary"
                     and ev.get("channel") != "config"]
        if summaries:
            lines.append("network health (comms):")
            for ev in summaries:
                parts = [f"{ev.get('messages_received', 0)} in / "
                         f"{ev.get('messages_sent', 0)} out"]
                if ev.get("bytes_sent") or ev.get("bytes_received"):
                    parts.append(
                        f"{_fmt_bytes(ev.get('bytes_received', 0))} in / "
                        f"{_fmt_bytes(ev.get('bytes_sent', 0))} out wire")
                for key, label in (("retries", "retries"),
                                   ("timeouts", "timeouts"),
                                   ("stale_dropped", "stale"),
                                   ("corrupt_dropped", "corrupt")):
                    if ev.get(key):
                        parts.append(f"{ev[key]} {label}")
                if ev.get("peers_lost"):
                    parts.append(f"peers lost {ev['peers_lost']}")
                lines.append(f"  {ev.get('channel', '?')}: "
                             + ", ".join(parts))
        # Deployment fast-path numbers (bench_deployment.py metric events).
        deploy = [ev for ev in events if ev.get("event") == "metric"
                  and str(ev.get("metric", "")).startswith(
                      "deployment_rounds_per_sec")]
        for ev in deploy:
            extras = []
            if ev.get("speedup_vs_legacy") is not None:
                extras.append(f"{ev['speedup_vs_legacy']}x vs legacy wire")
            if ev.get("staleness") is not None:
                extras.append(f"staleness {ev['staleness']}")
            lines.append(
                f"deployment bench: {_fmt(ev.get('value'))} "
                f"{ev.get('unit', '')}".rstrip()
                + (f" ({', '.join(extras)})" if extras else ""))
        losses = [ev for ev in events if ev.get("event") == "peer_lost"]
        if losses:
            for ev in losses:
                where = (f"robot {ev['robot']}" if "robot" in ev else "bus")
                why = f" ({ev['reason']})" if ev.get("reason") else ""
                lines.append(f"  peer_lost: {where} lost peer "
                             f"{ev.get('peer')}{why}")

        timers = [ev for ev in events if ev.get("event") == "phase_timings"]
        if timers:
            lines.append("phase timings (last snapshot):")
            for phase, row in sorted(
                    timers[-1].get("timings", {}).items(),
                    key=lambda kv: -kv[1].get("total_s", 0.0)):
                lines.append(
                    f"  {phase}: {row.get('total_s', 0.0):.4f}s "
                    f"/ {row.get('count', 0)} "
                    f"({row.get('avg_ms', 0.0):.2f} ms avg)")

        sharded_sec = _sharded_lines(sharded_stats(events))
        serving_sec = _serving_lines(serving_stats(events))
        certs = _cert_lines(cert_stats(events))
        if certs:
            # The tallies belong to whichever plane solved: sharded
            # section first, serving next, standalone for a plain solve.
            if sharded_sec:
                sharded_sec.extend(certs)
            elif serving_sec:
                serving_sec.extend(certs)
            else:
                sharded_sec = ["certificates:"] + certs
        lines.extend(sharded_sec)
        lines.extend(_devprof_lines(devprof_stats(events)))
        lines.extend(serving_sec)
        lines.extend(_health_lines(events))
        lines.extend(_fleet_lines(fleet_timeline_stats(events)))
        lines.extend(_fleet_serve_lines(fleet_serve_stats(events)))
    else:
        lines.append("events: none")

    m_path = os.path.join(run_dir, METRICS_FILE)
    if os.path.exists(m_path):
        with open(m_path) as fh:
            snap = json.load(fh)
        metrics = snap.get("metrics", {})
        lines.append("metrics snapshot:")
        for name, fam in sorted(metrics.items()):
            if fam["kind"] == "histogram":
                lines.extend(_histogram_summary(name, fam))
                continue
            for s in fam.get("series", []):
                labels = ",".join(f"{k}={v}"
                                  for k, v in sorted(s["labels"].items()))
                lab = f"{{{labels}}}" if labels else ""
                unit = f" {fam['unit']}" if fam.get("unit") else ""
                lines.append(f"  {name}{lab}: {_fmt(s.get('value'))}{unit}")
    else:
        lines.append("metrics snapshot: none (run not closed?)")
    return "\n".join(lines)


def report_data(run_dir: str) -> dict:
    """Machine-readable report for one run dir (the ``--json`` payload)."""
    out: dict = {"run_dir": run_dir}
    meta_path = os.path.join(run_dir, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            out["run"] = json.load(fh).get("run")
    ev_path = os.path.join(run_dir, EVENTS_FILE)
    events, truncated = read_events_meta(ev_path) \
        if os.path.exists(ev_path) else ([], False)
    out["truncated"] = truncated
    out["num_events"] = len(events)
    if events:
        out["duration_s"] = events[-1]["t_mono"] - events[0]["t_mono"]
        out["event_kinds"] = dict(_TallyCounter(
            ev.get("event", "?") for ev in events))
        out["metric_events"] = [
            ev for ev in events if ev.get("event") == "metric"]
        out["network"] = [ev for ev in events
                          if ev.get("event") == "run_summary"
                          and ev.get("channel") != "config"]
        fp: dict = {}
        for ev in events:
            if ev.get("event") == "run_summary" \
                    and ev.get("channel") == "config":
                fp.update(ev.get("fingerprint") or {})
        out["fingerprint"] = fp
        out["anomalies"] = [ev for ev in events
                            if ev.get("event") in ("anomaly",
                                                   "peer_anomaly",
                                                   "blackbox_dump")]
        out["sharded"] = sharded_stats(events)
        out["serving"] = serving_stats(events)
        out["devprof"] = devprof_stats(events)
        out["certificates"] = cert_stats(events)
        out["fleet_timeline"] = fleet_timeline_stats(events)
        out["fleet"] = fleet_serve_stats(events)
    m_path = os.path.join(run_dir, METRICS_FILE)
    if os.path.exists(m_path):
        with open(m_path) as fh:
            out["metrics"] = json.load(fh).get("metrics", {})
    return out


def _run_dir_error(rd: str) -> str | None:
    """Reject a missing or empty run dir with a clean message."""
    if not os.path.isdir(rd):
        return f"not a run directory: {rd}"
    if not any(os.path.exists(os.path.join(rd, f))
               for f in (EVENTS_FILE, METRICS_FILE, META_FILE)):
        return f"empty run directory (no telemetry artifacts): {rd}"
    return None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dpgo_tpu_torch.obs.report", description=__doc__)
    ap.add_argument("run_dir", nargs="*",
                    help="telemetry run directory (holds events.jsonl)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (one JSON document per "
                         "run dir) instead of the text report")
    ap.add_argument("--compare", nargs=2, metavar=("RUN_A", "RUN_B"),
                    help="convergence regression gate: compare two runs, "
                         "exit 2 on regression or incomparable configs")
    ap.add_argument("--rtol", type=float, default=0.05,
                    help="--compare: relative tolerance over run A's tail "
                         "noise band (default 0.05)")
    ap.add_argument("--allow-mismatch", action="store_true",
                    help="--compare: proceed despite fingerprint mismatches")
    ap.add_argument("--live", metavar="HOST:PORT",
                    help="scrape a running serve sidecar's /statusz "
                         "(--metrics-port) and render the live status")
    ap.add_argument("--fleet", action="store_true",
                    help="with --live: the target is a fleet-level "
                         "aggregated /statusz (obs.fleetobs."
                         "FleetSidecar); unreachable replicas render "
                         "marked in a partial view, rc 0")
    ap.add_argument("--ledger", nargs="?", const=".", metavar="ROOT",
                    help="render the cross-round perf ledger over the "
                         "BENCH_r*/MULTICHIP_r*/FLEET_r* records under "
                         "ROOT (default: cwd); --json emits the LEDGER "
                         "record tools/check_bench_floor.py validates")
    args = ap.parse_args(argv)
    if args.live:
        return live_report(args.live, json_out=args.json,
                           fleet=args.fleet)
    if args.ledger is not None:
        from .ledger import load_ledger

        ledger = load_ledger(args.ledger)
        if not ledger.rows:
            print(f"no bench records found under {args.ledger}",
                  file=sys.stderr)
            return 2
        print(json.dumps(ledger.to_json()) if args.json
              else ledger.render())
        return 0
    if args.compare:
        from .regress import run_compare

        return run_compare(args.compare[0], args.compare[1],
                           rtol=args.rtol, json_out=args.json,
                           allow_mismatch=args.allow_mismatch)
    if not args.run_dir:
        ap.error("at least one run_dir is required (or --compare A B, "
                 "or --ledger [ROOT])")
    rc = 0
    try:
        for rd in args.run_dir:
            err = _run_dir_error(rd)
            if err is not None:
                print(err, file=sys.stderr)
                rc = 2
                continue
            if args.json:
                print(json.dumps(report_data(rd)))
            else:
                print(render_report(rd))
    except BrokenPipeError:
        # Downstream pager/head closed the pipe — normal CLI etiquette.
        try:
            sys.stdout.close()
        except OSError:
            pass
    return rc


if __name__ == "__main__":
    sys.exit(main())

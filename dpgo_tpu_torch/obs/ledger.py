"""Cross-round perf ledger: every checked-in bench record, one table.

The repo accumulates one bench record per growth round —
``BENCH_r*.json`` (single-device kernel arm), ``MULTICHIP_r*.json``
(sharded mesh arm), ``FLEET_r*.json`` (serve fleet arm) — but until now
nothing read them *together*: the regress gate compares exactly two
telemetry runs, and ``check_bench_floor.py`` validates exactly one
record.  A perf question that spans rounds ("did rounds/s ever dip?",
"has overlap efficiency always been negative on this mesh?") meant
opening files by hand.

``PerfLedger`` ingests every record into a round-indexed table of
normalized rows::

    {"family": "BENCH" | "MULTICHIP" | "FLEET",
     "round":  int,            # NN from the _rNN filename
     "file":   str,            # basename, for provenance
     "ok":     bool,           # rc == 0 / record's own ok flag
     "metric": str | None,     # headline metric name (None: placeholder)
     "value":  float | None,
     "unit":   str | None,
     "extras": dict}           # trend-worthy scalars (vs_baseline,
                               # overlap_efficiency, host syncs, ...)

Early rounds are kept as honest placeholders: MULTICHIP r01–r05 predate
the sharded solver's metric record (r01 is a genuine failed run,
``ok=false``) and still appear as rows — the ledger's coverage claim is
"every round is accounted for", not "every round produced a number".

Consumers:

* ``report --ledger`` renders the trend table (``--json`` for the
  machine form, which ``tools/check_bench_floor.py`` schema-validates).
* ``regress.trend_gate`` turns a ledger into a cross-round gate: for
  each directioned trend series, the newest reading must not regress
  beyond tolerance against the best previous round.

The ledger is offline tooling over static JSON — it never rides the
solve path, and the ``PerfLedger`` constructor sits behind the same
DPG002 fence discipline as every other obs object (constructed only in
this module, via ``load_ledger``).

The PyTorch port's copy of ``dpgo_tpu.obs.ledger``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re

__all__ = ["PerfLedger", "load_ledger", "discover_records"]

#: filename pattern -> record family.
_FAMILY_PATTERNS = (
    ("BENCH", re.compile(r"^BENCH_r(\d+)\.json$")),
    ("MULTICHIP", re.compile(r"^MULTICHIP_r(\d+)\.json$")),
    ("FLEET", re.compile(r"^FLEET_r(\d+)\.json$")),
)

#: extras lifted into trend series when present on a row, in render order.
TREND_EXTRAS = ("vs_baseline", "kernel_parity_max_abs_diff",
                "host_syncs_per_100_rounds", "overlap_efficiency",
                "scaling_1_to_2")


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(x)


def discover_records(root: str) -> list[tuple[str, int, str]]:
    """All ``(family, round, path)`` bench records under ``root``,
    sorted by family then round."""
    found = []
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        base = os.path.basename(path)
        for family, pat in _FAMILY_PATTERNS:
            m = pat.match(base)
            if m:
                found.append((family, int(m.group(1)), path))
                break
    found.sort(key=lambda t: (t[0], t[1]))
    return found


def _normalize_bench(rec: dict) -> dict:
    """``bench.py`` driver record: {n, cmd, rc, tail, parsed:{...}}."""
    parsed = rec.get("parsed") if isinstance(rec.get("parsed"), dict) else {}
    extras = {}
    for key in ("vs_baseline", "kernel_parity_max_abs_diff", "sel_mode"):
        if key in parsed:
            extras[key] = parsed[key]
    band = parsed.get("cpu_arm_band")
    if isinstance(band, dict) and _num(band.get("min")) \
            and _num(band.get("max")):
        extras["band_min"], extras["band_max"] = band["min"], band["max"]
    return {"ok": rec.get("rc") == 0,
            "metric": parsed.get("metric"),
            "value": parsed["value"] if _num(parsed.get("value")) else None,
            "unit": parsed.get("unit"),
            "extras": extras}


def _normalize_multichip(rec: dict) -> dict:
    """Placeholder rounds carry only {n_devices, rc, ok, skipped, tail};
    the full MULTICHIP record (record=="MULTICHIP") has the metric."""
    extras = {}
    if _num(rec.get("n_devices")):
        extras["n_devices"] = rec["n_devices"]
    if rec.get("skipped"):
        extras["skipped"] = True
    if rec.get("record") != "MULTICHIP":
        return {"ok": bool(rec.get("ok")), "metric": None, "value": None,
                "unit": None, "extras": extras}
    for key in ("verdict_every", "host_syncs_per_100_rounds"):
        if _num(rec.get(key)):
            extras[key] = rec[key]
    ov = rec.get("overlap")
    if isinstance(ov, dict) and _num(ov.get("efficiency")):
        extras["overlap_efficiency"] = ov["efficiency"]
    scale = rec.get("scale_test")
    if isinstance(scale, dict) and "cert_status" in scale:
        extras["cert_status"] = scale["cert_status"]
    return {"ok": bool(rec.get("ok")),
            "metric": rec.get("metric"),
            "value": rec["value"] if _num(rec.get("value")) else None,
            "unit": rec.get("unit"),
            "extras": extras}


def _normalize_fleet(rec: dict) -> dict:
    """FLEET record: headline value = QPS of the widest replica arm."""
    extras = {}
    qps = rec.get("qps")
    value = None
    if isinstance(qps, list) and qps:
        widest = max((a for a in qps if _num(a.get("qps"))),
                     key=lambda a: a.get("replicas", 0), default=None)
        if widest is not None:
            value = widest["qps"]
            extras["replicas"] = widest.get("replicas")
    if _num(rec.get("scaling_1_to_2")):
        extras["scaling_1_to_2"] = rec["scaling_1_to_2"]
    cold = rec.get("cold_start")
    if isinstance(cold, dict) and _num(cold.get("compile_seconds_total")):
        extras["cold_compile_s"] = cold["compile_seconds_total"]
    return {"ok": bool(rec.get("ok")), "metric": "fleet_qps",
            "value": value, "unit": "problems/s", "extras": extras}


_NORMALIZERS = {"BENCH": _normalize_bench,
                "MULTICHIP": _normalize_multichip,
                "FLEET": _normalize_fleet}


class PerfLedger:
    """The round-indexed trend table (see module docstring).

    Rows are immutable once loaded; accessors slice them into per-family
    trend series for the report renderer and the regress trend gate.
    """

    def __init__(self, rows: list[dict], root: str = "."):
        self.rows = list(rows)
        self.root = str(root)

    # -- accessors ---------------------------------------------------

    def families(self) -> list[str]:
        return sorted({r["family"] for r in self.rows})

    def family_rows(self, family: str) -> list[dict]:
        return [r for r in self.rows if r["family"] == family]

    def series(self, family: str, key: str = "value") -> list[tuple]:
        """``(round, value)`` trend for a family; ``key`` is ``"value"``
        (the headline metric) or an extras key.  Placeholder rounds
        (no reading) are skipped."""
        out = []
        for r in self.family_rows(family):
            v = r["value"] if key == "value" else r["extras"].get(key)
            if _num(v):
                out.append((r["round"], float(v)))
        return out

    # -- serialization ----------------------------------------------

    def to_json(self) -> dict:
        """The machine form ``check_bench_floor.py`` validates."""
        return {"record": "LEDGER", "root": self.root,
                "rounds": len(self.rows), "families": self.families(),
                "rows": self.rows}

    def render(self) -> str:
        lines = [f"== perf ledger: {len(self.rows)} rounds across "
                 f"{len(self.families())} families =="]
        for family in self.families():
            rows = self.family_rows(family)
            lines.append(f"[{family}] ({len(rows)} rounds)")
            lines.append(f"  {'round':>5} {'ok':<4} {'value':>12} "
                         f"{'unit':<12} extras")
            for r in rows:
                val = f"{r['value']:.6g}" if _num(r["value"]) else "-"
                unit = r["unit"] or "-"
                extras = ", ".join(
                    f"{k}={r['extras'][k]:.4g}"
                    if _num(r["extras"][k]) else f"{k}={r['extras'][k]}"
                    for k in TREND_EXTRAS + ("sel_mode", "cert_status",
                                             "n_devices", "skipped")
                    if k in r["extras"])
                ok = "ok" if r["ok"] else "FAIL"
                lines.append(f"  r{r['round']:>04d} {ok:<4} {val:>12} "
                             f"{unit:<12} {extras}")
            # Trend summary per directioned series (delta last vs first).
            for key in ("value",) + TREND_EXTRAS:
                pts = self.series(family, key)
                if len(pts) >= 2:
                    (r0, v0), (r1, v1) = pts[0], pts[-1]
                    name = "value" if key == "value" else key
                    delta = f"{100.0 * (v1 - v0) / abs(v0):+.1f}%" \
                        if abs(v0) > 0 else f"{v1 - v0:+.4g}"
                    lines.append(f"  trend {name}: r{r0:02d} {v0:.6g} -> "
                                 f"r{r1:02d} {v1:.6g} ({delta} over "
                                 f"{len(pts)} readings)")
        return "\n".join(lines)


def load_ledger(root: str = ".") -> PerfLedger:
    """Ingest every bench record under ``root`` into a ``PerfLedger``.

    Unreadable files become ``ok=false`` placeholder rows rather than
    raising — a corrupt round is a finding the ledger should show, not
    an excuse to hide the other rounds."""
    rows = []
    for family, rnd, path in discover_records(root):
        base = os.path.basename(path)
        try:
            with open(path) as fh:
                rec = json.load(fh)
            if not isinstance(rec, dict):
                raise ValueError("record is not a JSON object")
        except (OSError, ValueError) as e:
            rows.append({"family": family, "round": rnd, "file": base,
                         "ok": False, "metric": None, "value": None,
                         "unit": None, "extras": {"error": str(e)}})
            continue
        row = _NORMALIZERS[family](rec)
        row.update({"family": family, "round": rnd, "file": base})
        rows.append(row)
    return PerfLedger(rows, root=root)

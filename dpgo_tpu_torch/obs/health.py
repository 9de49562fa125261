"""In-band numerical-health anomaly detection.

The PR-1 metrics and PR-4 tracing *time* the solver; this module *judges*
it.  A ``HealthMonitor`` consumes the scalars the driver already reads back
per eval (``run_rbcd``'s stacked readback — zero extra device transfers)
and the per-robot signals of the deployment plane, and turns numerical
failure modes into structured ``anomaly`` events:

* ``non_finite`` — NaN/Inf sentinel on cost / gradient norm / per-agent
  relative change (the silent-divergence case: a NaN'd run otherwise looks
  identical to a healthy one until the final cost).
* ``cost_spike`` — non-monotone centralized cost beyond a per-GNC-stage
  tolerance.  GNC mu updates legitimately jump the cost (the objective
  being minimized changes), so the monotonicity baseline resets on every
  stage transition (``robust.gnc_stage_index``) instead of flagging the
  anneal schedule itself.
* ``grad_explosion`` — gradient norm blowing past the stage's running
  minimum by a large factor (trust-region rejection storms, bad
  preconditioner shifts).
* ``stall`` — no relative cost improvement over a window of evals while
  the solve keeps burning rounds (plateau detection; fired once per GNC
  stage).
* ``inlier_collapse`` — GNC inlier fraction dropping below an absolute
  floor or falling hard from its running maximum (the correlated-
  corruption breakdown mode of docs/NEXT.md item 4).
* ``cert_refuse_loop`` — consecutive undecidable certification verdicts
  (``certify_solution`` / ``certify_sharded`` REFUSE streaks).

Every anomaly emits one ``anomaly`` event (kind, severity, iteration,
GNC stage, numeric context), increments the ``anomalies_total`` counter,
invokes registered callbacks, optionally triggers a flight-recorder dump
(``obs.recorder``, when one is attached to the run), and — per the
configured abort policy — raises ``SolverHealthError`` so a doomed run
stops burning device hours.

Zero-overhead fence: a monitor only exists attached to a live
``TelemetryRun`` (``monitor_for`` returns None with telemetry off), so
``tests/test_obs.py``'s telemetry-off test patches
``HealthMonitor.__init__`` to throw and proves no detector is ever
constructed on the off path.

The PyTorch port's copy of ``dpgo_tpu.obs.health``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

from .run import get_run

__all__ = [
    "HealthConfig",
    "HealthMonitor",
    "SolverHealthError",
    "monitor_for",
    "SEVERITIES",
]

#: Severity order, mild to fatal.
SEVERITIES = ("warning", "critical")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


class SolverHealthError(RuntimeError):
    """Raised by the abort policy: the run is numerically doomed.

    ``anomalies`` holds the anomaly record(s) that tripped the policy —
    the same dicts emitted as ``anomaly`` events."""

    def __init__(self, anomalies: list[dict]):
        self.anomalies = list(anomalies)
        kinds = ", ".join(a["kind"] for a in self.anomalies)
        super().__init__(f"solver health abort: {kinds}")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds and policies.

    Defaults are deliberately loose — the detectors must stay silent on
    every healthy run in the test suite and flag only genuinely broken
    numerics; tighten per-run for gating."""

    # Non-monotone cost tolerance within one GNC stage: flag when the cost
    # exceeds the stage's best by more than rtol (relative) + atol.
    cost_spike_rtol: float = 0.5
    cost_spike_atol: float = 1e-9
    # Gradient norm explosion: flag when gn > factor * max(stage min, floor).
    grad_explosion_factor: float = 1e4
    grad_floor: float = 1e-9
    # Stall: over `stall_window` consecutive evals the cost improved by
    # less than stall_rtol (relative) — fired once per GNC stage, and only
    # after the window fills.  <= 1 disables.
    stall_window: int = 12
    stall_rtol: float = 1e-5
    # GNC inlier-fraction collapse: below the absolute floor, or a drop of
    # more than `inlier_collapse_drop` from the running maximum.
    inlier_collapse_frac: float = 0.02
    inlier_collapse_drop: float = 0.6
    # Certification REFUSE loop: this many consecutive undecidable verdicts.
    cert_refuse_streak: int = 3
    # Abort policy: anomaly kinds (e.g. "non_finite") and/or severities
    # (e.g. "critical") that raise SolverHealthError.  Empty = never abort.
    abort_on: frozenset = frozenset()
    # Minimum severity that triggers a flight-recorder dump when a recorder
    # is attached to the run ("warning" | "critical" | "never").
    dump_on: str = "critical"


class HealthMonitor:
    """Per-run anomaly detector state.  Not thread-safe per call — the
    solver driver observes from one thread; the deployment plane's
    ``anomaly()`` reports are independent events and take no shared
    detector state."""

    def __init__(self, run, config: HealthConfig | None = None):
        self.run = run
        self.config = config or HealthConfig()
        self.anomalies: list[dict] = []
        self._callbacks: list = []
        # Per-GNC-stage baselines.
        self._stage = 0
        self._last_mu: float | None = None
        self._best_cost: float | None = None
        self._min_gn: float | None = None
        self._cost_window: deque = deque(maxlen=max(self.config.stall_window, 1))
        self._stalled_stage = False
        self._collapsed_stage = False
        self._max_inlier: float | None = None
        self._cert_refusals = 0
        self._cert_loop_flagged = False

    # -- plumbing -----------------------------------------------------------

    def on_anomaly(self, callback) -> None:
        """Register ``callback(record: dict)`` invoked on every anomaly."""
        self._callbacks.append(callback)

    def _record(self, kind: str, severity: str, iteration=None,
                **fields) -> dict:
        rec = {"kind": kind, "severity": severity, "stage": self._stage}
        if iteration is not None:
            rec["iteration"] = int(iteration)
        rec.update(fields)
        self.anomalies.append(rec)
        self.run.event("anomaly", phase="health", **rec)
        labels = {"kind": kind, "severity": severity}
        if "robot" in rec:
            labels["robot"] = rec["robot"]
        self.run.counter("anomalies_total",
                         "numerical-health anomalies detected").inc(1, **labels)
        for cb in self._callbacks:
            cb(rec)
        cfg = self.config
        if cfg.dump_on != "never" and \
                _SEV_RANK[severity] >= _SEV_RANK.get(cfg.dump_on, 99):
            rec_dump = getattr(self.run, "recorder", None)
            if rec_dump is not None:
                rec_dump.dump(f"anomaly:{kind}")
        return rec

    def _maybe_abort(self, fired: list[dict]) -> None:
        ab = self.config.abort_on
        if not ab:
            return
        trip = [a for a in fired if a["kind"] in ab or a["severity"] in ab]
        if trip:
            raise SolverHealthError(trip)

    # -- the solver path (run_rbcd eval scalars) ----------------------------

    def _new_stage(self) -> None:
        self._stage += 1
        self._best_cost = None
        self._min_gn = None
        self._cost_window.clear()
        self._stalled_stage = False
        self._collapsed_stage = False

    def observe_solver(self, iteration: int, cost: float, grad_norm: float,
                       mu: float | None = None,
                       inlier_frac: float | None = None,
                       rel_change=None, stage: int | None = None) -> list[dict]:
        """Judge one eval's scalars; returns the anomalies fired (possibly
        raising per the abort policy).  ``rel_change`` may be a per-agent
        array (already host-side — the caller's readback materialized it).
        ``stage`` overrides the mu-transition stage counter when the caller
        knows the GNC stage index (``robust.gnc_stage_index``)."""
        cfg = self.config
        fired: list[dict] = []
        if mu is not None:
            if self._last_mu is not None and mu != self._last_mu:
                self._new_stage()
            self._last_mu = float(mu)
        if stage is not None:
            if stage != self._stage:
                self._new_stage()
            self._stage = int(stage)

        bad = []
        if not math.isfinite(cost):
            bad.append(("cost", cost))
        if not math.isfinite(grad_norm):
            bad.append(("grad_norm", grad_norm))
        rel_bad = []
        if rel_change is not None:
            for a, v in enumerate(rel_change):
                if not math.isfinite(float(v)):
                    rel_bad.append(a)
        if bad or rel_bad:
            rec = self._record(
                "non_finite", "critical", iteration,
                signals=[k for k, _ in bad],
                agents=rel_bad or None,
                cost=cost, grad_norm=grad_norm)
            fired.append(rec)
            self._maybe_abort(fired)
            return fired

        # Cost monotonicity within the stage.
        if self._best_cost is not None and \
                cost > self._best_cost * (1.0 + cfg.cost_spike_rtol) \
                + cfg.cost_spike_atol:
            fired.append(self._record(
                "cost_spike", "warning", iteration, cost=cost,
                stage_best=self._best_cost,
                ratio=cost / self._best_cost if self._best_cost else None))
        self._best_cost = cost if self._best_cost is None \
            else min(self._best_cost, cost)

        # Gradient-norm explosion vs the stage's running minimum.
        if self._min_gn is not None:
            ref = max(self._min_gn, cfg.grad_floor)
            if grad_norm > cfg.grad_explosion_factor * ref:
                fired.append(self._record(
                    "grad_explosion", "critical", iteration,
                    grad_norm=grad_norm, stage_min=self._min_gn,
                    factor=grad_norm / ref))
        self._min_gn = grad_norm if self._min_gn is None \
            else min(self._min_gn, grad_norm)

        # Stall / plateau.
        if cfg.stall_window > 1:
            self._cost_window.append(cost)
            if (len(self._cost_window) == cfg.stall_window
                    and not self._stalled_stage):
                first, last = self._cost_window[0], self._cost_window[-1]
                if first - last <= cfg.stall_rtol * abs(first):
                    self._stalled_stage = True
                    fired.append(self._record(
                        "stall", "warning", iteration, cost=cost,
                        window=cfg.stall_window,
                        improvement=first - last))

        # GNC inlier-fraction collapse.
        if inlier_frac is not None:
            f = float(inlier_frac)
            if (self._max_inlier is not None and not self._collapsed_stage
                    and (f < cfg.inlier_collapse_frac
                         or f < self._max_inlier - cfg.inlier_collapse_drop)):
                self._collapsed_stage = True
                fired.append(self._record(
                    "inlier_collapse", "critical", iteration,
                    inlier_fraction=f, running_max=self._max_inlier))
            self._max_inlier = f if self._max_inlier is None \
                else max(self._max_inlier, f)

        self._maybe_abort(fired)
        return fired

    # -- certification verdict timeline -------------------------------------

    def observe_certificate(self, certified: bool, decidable: bool,
                            lambda_min: float | None = None,
                            **fields) -> list[dict]:
        """Track the certification outcome stream; flags a REFUSE loop
        (consecutive undecidable verdicts) once per streak."""
        fired: list[dict] = []
        if decidable:
            self._cert_refusals = 0
            self._cert_loop_flagged = False
        else:
            self._cert_refusals += 1
            if (self._cert_refusals >= self.config.cert_refuse_streak
                    and not self._cert_loop_flagged):
                self._cert_loop_flagged = True
                fired.append(self._record(
                    "cert_refuse_loop", "warning",
                    refusals=self._cert_refusals,
                    lambda_min=lambda_min, **fields))
        self._maybe_abort(fired)
        return fired

    # -- deployment plane (per-robot ad-hoc reports) ------------------------

    def anomaly(self, kind: str, severity: str = "warning",
                iteration=None, **fields) -> dict:
        """Report one externally-detected anomaly (the per-agent NaN
        sentinels of ``agent.PGOAgent`` land here).  Applies the dump and
        abort policies like the built-in detectors."""
        rec = self._record(kind, severity, iteration, **fields)
        self._maybe_abort([rec])
        return rec


def monitor_for(run=None, config: HealthConfig | None = None) -> HealthMonitor | None:
    """The run's health monitor (created on first use), or None with
    telemetry off — the zero-overhead fence.  Pass ``config`` on the
    first call (before any instrumented solve observes) to set policy;
    a later call with a config replaces the monitor."""
    run = get_run() if run is None else run
    if run is None:
        return None
    mon = getattr(run, "_health_monitor", None)
    if mon is None or config is not None:
        mon = run._health_monitor = HealthMonitor(run, config)
    return mon

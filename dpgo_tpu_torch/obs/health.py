"""Numerical-health thresholds (the port's copy of
``dpgo_tpu.obs.health.HealthConfig``).  The device-resident verdict
program (``models.rbcd.make_verdict_program``) folds these detectors into
its packed word; the host-side ``HealthMonitor`` is not ported yet (A10).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds and policies, with the JAX package's defaults.

    Defaults are deliberately loose: the detectors stay silent on healthy
    runs and flag only broken numerics."""

    # Non-monotone cost within one GNC stage: flag when the cost exceeds
    # the stage's best by more than rtol (relative) + atol.
    cost_spike_rtol: float = 0.5
    cost_spike_atol: float = 1e-9
    # Gradient norm explosion: flag when gn > factor * max(stage min, floor).
    grad_explosion_factor: float = 1e4
    grad_floor: float = 1e-9
    # Stall: over `stall_window` consecutive evals the cost improved by
    # less than stall_rtol (relative); fired once per GNC stage, after the
    # window fills.  <= 1 disables.
    stall_window: int = 12
    stall_rtol: float = 1e-5
    # GNC inlier-fraction collapse: below the absolute floor, or a drop of
    # more than `inlier_collapse_drop` from the running maximum.
    inlier_collapse_frac: float = 0.02
    inlier_collapse_drop: float = 0.6
    # Certification REFUSE loop: this many consecutive undecidable verdicts.
    cert_refuse_streak: int = 3
    # Abort policy: anomaly kinds and/or severities that raise.  Empty =
    # never abort.
    abort_on: frozenset = frozenset()
    # Minimum severity that triggers a flight-recorder dump
    # ("warning" | "critical" | "never").
    dump_on: str = "critical"

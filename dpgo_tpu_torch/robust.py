"""Robust cost weight functions (port of ``dpgo_tpu.robust``; reference
``src/DPGO_robust.cpp:23-103``, ``RobustCost``).

The weight functions are pure and batched: the GNC control parameter
``mu`` lives in the solver state (``models.rbcd.RBCDState.mu``) and is
advanced functionally (``gnc_update_mu``), so a weight-update round is
plain tensor math with no host round trip.
"""

from __future__ import annotations

import math

import torch

from .config import RobustCostParams, RobustCostType


def weight(r: torch.Tensor, params: RobustCostParams,
           mu: torch.Tensor | float = 0.0) -> torch.Tensor:
    """Weight w(r) in [0, 1] for residual norms ``r`` (elementwise), the
    reference ``RobustCost::weight`` (``DPGO_robust.cpp:23-67``) for every
    cost type; ``mu`` is the GNC control parameter (GNC_TLS only)."""
    ct = params.cost_type
    if ct == RobustCostType.L2:
        return torch.ones_like(r)
    if ct == RobustCostType.L1:
        return 1.0 / r
    if ct == RobustCostType.Huber:
        return torch.where(r < params.huber_threshold, 1.0,
                           params.huber_threshold / r)
    if ct == RobustCostType.TLS:
        return torch.where(r < params.tls_threshold, 1.0, 0.0).to(r.dtype)
    if ct == RobustCostType.GM:
        a = 1.0 + r * r
        return 1.0 / (a * a)
    if ct == RobustCostType.GNC_TLS:
        # The reference keeps mu as managed internal state, always positive;
        # here it is explicit, and with mu = 0 every residual would map to
        # weight 0.
        if isinstance(mu, (int, float)) and mu <= 0:
            raise ValueError("GNC_TLS requires a positive mu (e.g. "
                             "params.gnc_init_mu)")
        return gnc_tls_weight(r, mu, params.gnc_barc)
    raise NotImplementedError(f"weight function for {ct} is not implemented")


def gnc_tls_weight(r: torch.Tensor, mu: torch.Tensor | float,
                   barc: float) -> torch.Tensor:
    """GNC-TLS weight, eq. (14) of the GNC paper (reference
    ``DPGO_robust.cpp:49-62``):

    w = 0                                  if r^2 >= (mu+1)/mu * barc^2
      = 1                                  if r^2 <= mu/(mu+1) * barc^2
      = sqrt(barc^2 mu (mu+1) / r^2) - mu  otherwise
    """
    barc_sq = barc * barc
    r_sq = r * r
    upper = (mu + 1.0) / mu * barc_sq
    lower = mu / (mu + 1.0) * barc_sq
    # Guard the sqrt against r = 0 in the (unused) middle branch.
    safe_r_sq = torch.clamp(r_sq, min=1e-30)
    mid = torch.sqrt(barc_sq * mu * (mu + 1.0) / safe_r_sq) - mu
    w = torch.where(r_sq >= upper, 0.0, torch.where(r_sq <= lower, 1.0, mid))
    return torch.clamp(w, 0.0, 1.0)


def gnc_update_mu(mu: torch.Tensor, params: RobustCostParams) -> torch.Tensor:
    """One GNC annealing step: mu <- mu_step * mu, capped after
    ``gnc_max_iters`` steps (reference ``RobustCost::update``,
    ``DPGO_robust.cpp:85-103``)."""
    mu_max = params.gnc_init_mu * params.gnc_mu_step ** params.gnc_max_iters
    return torch.clamp(mu * params.gnc_mu_step, max=mu_max)


def gnc_init_mu(params: RobustCostParams) -> float:
    return params.gnc_init_mu


def gnc_stage_index(mu, params: RobustCostParams) -> int:
    """Host-side GNC stage label: the annealing steps taken to reach ``mu``
    from ``gnc_init_mu`` (0 before the first update, capped at
    ``gnc_max_iters``).  Float math on a value already read back."""
    mu = float(mu)
    mu0 = float(params.gnc_init_mu)
    step = float(params.gnc_mu_step)
    if mu <= 0 or mu0 <= 0 or step <= 1.0 or mu <= mu0:
        return 0
    k = round(math.log(mu / mu0) / math.log(step))
    return max(0, min(int(k), int(params.gnc_max_iters)))


def is_weight_converged(w: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
    """Elementwise: has this edge's GNC weight converged to {0, 1}?  (The
    reference's ``computeConvergedLoopClosureRatio`` counts exact 0s and
    1s, ``PGOAgent.cpp:1247-1289``; GNC-TLS's outer branches return exact
    constants, so the tolerance only absorbs rounding.)"""
    return (w < tol) | (w > 1.0 - tol)

"""Single-pose rotation / translation averaging, plain and robust (GNC-TLS)
— the PyTorch port of ``dpgo_tpu.ops.averaging``.

Reference ``src/DPGO_utils.cpp:533-726``.  Inputs are batched ``[k, d, d]``
/ ``[k, d]`` stacks.  The GNC loop is a Python loop over tensors: this is a
one-time host-driven phase (the distributed initialization's frame
alignment, ``PGOAgent.cpp:290-331``), so it reads the host once to decide
whether to run GNC at all and once per GNC iteration for its stop test;
``HOST_READS`` counts those reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import robust
from ..config import RobustCostParams, RobustCostType
from ..utils.lie import project_to_rotation

#: Host reads of the robust averaging loops (the skip test and one stop test
#: per GNC iteration), for callers that count a phase's syncs.
HOST_READS = 0


def _w_tol(dtype: torch.dtype) -> float:
    """Weight convergence tolerance (reference 1e-8, DPGO_utils.cpp:585),
    widened to a few ulps of the compute dtype when that is coarser: in
    float32 ``1.0 - 1e-8`` rounds to 1.0, and ``w > 1.0 - 1e-8`` would
    hold for no weight at all."""
    return max(1e-8, 32.0 * float(torch.finfo(dtype).eps))


def single_translation_averaging(ts: torch.Tensor,
                                 tau: torch.Tensor | None = None,
                                 mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Weighted mean of translations ``ts [k, d]`` (reference
    ``DPGO_utils.cpp:533-550``); all-zero weights give 0, not NaN."""
    w = torch.ones(ts.shape[0], dtype=ts.dtype, device=ts.device) \
        if tau is None else tau
    if mask is not None:
        w = w * mask
    return (w[:, None] * ts).sum(0) / torch.clamp(w.sum(), min=1e-30)


def single_rotation_averaging(Rs: torch.Tensor,
                              kappa: torch.Tensor | None = None,
                              mask: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Project the weighted sum of ``Rs [k, d, d]`` onto SO(d) (reference
    ``DPGO_utils.cpp:552-566``).  All-zero weights project the zero matrix:
    a finite, deterministic rotation (the identity), never NaN; callers
    detect the failure through the robust variants' empty inlier mask."""
    w = torch.ones(Rs.shape[0], dtype=Rs.dtype, device=Rs.device) \
        if kappa is None else kappa
    if mask is not None:
        w = w * mask
    return project_to_rotation((w[:, None, None] * Rs).sum(0))


def single_pose_averaging(Rs, ts, kappa=None, tau=None, mask=None):
    """Independent rotation and translation averaging (reference
    ``DPGO_utils.cpp:568-580``)."""
    return (single_rotation_averaging(Rs, kappa, mask),
            single_translation_averaging(ts, tau, mask))


class RobustAveragingResult(NamedTuple):
    R: torch.Tensor  # [d, d] averaged rotation
    t: torch.Tensor  # [d] averaged translation (zeros for rotation-only)
    inlier_mask: torch.Tensor  # [k] bool, weight > 1 - tol (see _w_tol)
    weights: torch.Tensor  # [k] final GNC weights


def _host_bool(x: torch.Tensor) -> bool:
    global HOST_READS
    HOST_READS += 1
    return bool(x)


def _gnc_averaging_loop(solve_fn, residual_sq_fn, init_sol, barc: float,
                        max_iters: int, weights0: torch.Tensor,
                        mask: torch.Tensor):
    """The GNC-TLS loop shared by the robust averages (reference
    ``robustSingleRotationAveraging``, ``DPGO_utils.cpp:582-644``):
    mu0 = min(barc^2 / (2 max rSq - barc^2), 1e-5); GNC is skipped when
    mu0 <= 0; it stops when every weight has reached {0, 1} or after
    ``max_iters`` iterations.  Returns ``(weights, solution)``."""
    barc = float(barc)  # a Python float keeps float32 weights float32
    barc_sq = barc * barc
    r_sq0 = residual_sq_fn(init_sol, weights0)
    max_r_sq = torch.max(torch.where(mask > 0, r_sq0,
                                     torch.zeros_like(r_sq0)))
    mu = torch.clamp(barc_sq / (2.0 * max_r_sq - barc_sq), max=1e-5)
    if not _host_bool(mu > 0):
        return weights0, init_sol
    params = RobustCostParams(cost_type=RobustCostType.GNC_TLS,
                              gnc_barc=barc)
    tol = _w_tol(weights0.dtype)
    weights, sol = weights0, init_sol
    for _ in range(max_iters):
        sol = solve_fn(weights)
        r_sq = residual_sq_fn(sol, weights)
        weights = robust.gnc_tls_weight(torch.sqrt(r_sq), mu, barc) * mask
        mu = robust.gnc_update_mu(mu, params)
        conv = (weights < tol) | (weights > 1.0 - tol) | (mask <= 0)
        if _host_bool(torch.all(conv)):
            break
    return weights, sol


def robust_single_rotation_averaging(
        Rs: torch.Tensor, kappa: torch.Tensor | None = None,
        error_threshold: float = 0.1, mask: torch.Tensor | None = None,
        max_iters: int = 1000) -> RobustAveragingResult:
    """GNC-TLS robust rotation averaging (reference ``DPGO_utils.cpp:582-
    644``).  ``error_threshold`` is the chordal barc (callers pass
    ``angular_to_chordal_so3(angle)``); residual^2 = kappa ||R - R_i||_F^2."""
    k = Rs.shape[0]
    ones = torch.ones(k, dtype=Rs.dtype, device=Rs.device)
    kappa_ = ones if kappa is None else kappa
    mask_ = ones if mask is None else mask.to(Rs.dtype)

    def solve(w):
        return single_rotation_averaging(Rs, kappa_ * w, mask_)

    def residual_sq(R, _w):
        return kappa_ * torch.sum((R[None] - Rs) ** 2, dim=(-2, -1))

    R0 = solve(ones)
    weights, _ = _gnc_averaging_loop(solve, residual_sq, R0,
                                     error_threshold, max_iters,
                                     ones * mask_, mask_)
    R = solve(weights)
    inliers = (weights > 1.0 - _w_tol(weights.dtype)) & (mask_ > 0)
    return RobustAveragingResult(
        R=R, t=torch.zeros(Rs.shape[-1], dtype=Rs.dtype, device=Rs.device),
        inlier_mask=inliers, weights=weights)


def robust_single_pose_averaging(
        Rs: torch.Tensor, ts: torch.Tensor,
        kappa: torch.Tensor | None = None, tau: torch.Tensor | None = None,
        error_threshold: float = 0.1, mask: torch.Tensor | None = None,
        max_iters: int = 10000) -> RobustAveragingResult:
    """GNC-TLS robust SE(d) averaging (reference ``DPGO_utils.cpp:646-
    726``): kappa = 1e4 and tau = 1e2 by default, residual^2 =
    kappa ||R - R_i||^2 + tau ||t - t_i||^2."""
    k = Rs.shape[0]
    ones = torch.ones(k, dtype=Rs.dtype, device=Rs.device)
    kappa_ = torch.full_like(ones, 1e4) if kappa is None else kappa
    tau_ = torch.full_like(ones, 1e2) if tau is None else tau
    mask_ = ones if mask is None else mask.to(Rs.dtype)

    def solve(w):
        return (single_rotation_averaging(Rs, kappa_ * w, mask_),
                single_translation_averaging(ts, tau_ * w, mask_))

    def residual_sq(sol, _w):
        R, t = sol
        return kappa_ * torch.sum((R[None] - Rs) ** 2, dim=(-2, -1)) + \
            tau_ * torch.sum((t[None] - ts) ** 2, dim=-1)

    sol0 = solve(ones)
    weights, _ = _gnc_averaging_loop(solve, residual_sq, sol0,
                                     error_threshold, max_iters,
                                     ones * mask_, mask_)
    R, t = solve(weights)
    inliers = (weights > 1.0 - _w_tol(weights.dtype)) & (mask_ > 0)
    return RobustAveragingResult(R=R, t=t, inlier_mask=inliers,
                                 weights=weights)

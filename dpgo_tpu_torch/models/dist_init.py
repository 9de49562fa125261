"""Distributed (multi-robot) initialization, the no-centralized-init path —
the PyTorch port of ``dpgo_tpu.models.dist_init``.

Reference ``PGOAgent::initializeInGlobalFrame`` and helpers
(``src/PGOAgent.cpp:250-432``): each agent initializes its trajectory in
its own frame from its private measurements (``localInitialization``,
``PGOAgent.cpp:947-962``), robot 0 anchors the global frame
(``PGOAgent.cpp:182-186``), and every other robot estimates the rigid
transform from its local frame to the global one from the inter-robot loop
closures it shares with an initialized neighbor, robustly, by GNC rotation
averaging over one candidate transform per shared edge.

The reference's message-driven protocol becomes a host-side BFS over the
robot adjacency from robot 0: each robot aligns against its best-connected
initialized neighbor and falls back to the others when the inlier set is
too small.  The candidates are float64 numpy, as the reference computes
in double, and the averaging runs on them in float64 (``ops.averaging``,
one host read per GNC iteration); the local inits and the lift run in
the problem's dtype on the graph's device.  A one-time host phase: the
RBCD rounds are unaffected.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..config import AgentParams, RobustCostType
from ..device import resolve_device
from ..ops import averaging, chordal
from ..types import edge_set_from_measurements
from ..utils.lie import angular_to_chordal_so3, error_threshold_at_quantile
from ..utils.partition import Partition
from .local_pgo import lift
from .rbcd import GraphMeta, MultiAgentGraph, lifting_matrix


def _se(R: np.ndarray, t: np.ndarray, d: int) -> np.ndarray:
    """(d+1)x(d+1) homogeneous matrix from (R [d,d], t [d])."""
    T = np.eye(d + 1)
    T[:d, :d] = R
    T[:d, d] = t
    return T


def _se_inv(T: np.ndarray, d: int) -> np.ndarray:
    R, t = T[:d, :d], T[:d, d]
    return _se(R.T, -R.T @ t, d)


def local_initialization(part: Partition, params: AgentParams,
                         dtype=torch.float64, device="cuda") -> np.ndarray:
    """Per-agent trajectory estimates in each agent's own frame,
    [A, n_max, d, d+1] (numpy float64 holding values computed in
    ``dtype`` on ``device``): the chordal init of the agent's private
    measurements under the L2 cost, odometry propagation under a robust
    one — the reference's ``localInitialization`` policy
    (``PGOAgent.cpp:947-962``; the chordal solve rejects no outlier)."""
    dev = resolve_device(device)
    meas = part.meas
    A = part.num_robots
    d = meas.d
    use_chordal = params.robust.cost_type == RobustCostType.L2
    out = np.zeros((A, part.n_max, d, d + 1))
    out[..., :d] = np.eye(d)
    for a in range(A):
        sel = (np.asarray(meas.r1) == a) & (np.asarray(meas.r2) == a)
        sub = dataclasses.replace(
            meas,
            num_poses=int(part.n[a]),
            r1=meas.r1[sel], p1=meas.p1[sel],
            r2=meas.r2[sel], p2=meas.p2[sel],
            R=meas.R[sel], t=meas.t[sel],
            kappa=meas.kappa[sel], tau=meas.tau[sel],
            weight=meas.weight[sel], is_known_inlier=meas.is_known_inlier[sel],
        )
        edges = edge_set_from_measurements(sub, dtype=dtype, device=dev)
        n_a = int(part.n[a])
        if use_chordal:
            T = chordal.chordal_initialization(edges, n_a)
        else:
            T = chordal.odometry_from_edges(edges, n_a)
        out[a, :n_a] = T.cpu().numpy()
    return out


def _alignment_candidates(part: Partition, T_local: np.ndarray,
                          T_global: np.ndarray, b: int, a: int):
    """Candidate frame-alignment transforms for robot ``b`` (uninitialized,
    frame ``world1``) from robot ``a`` (initialized, frame ``world2``): one
    per shared edge — the loop of ``computeRobustNeighborTransformTwoStage``
    (``PGOAgent.cpp:290-305``), each candidate ``computeNeighborTransform``
    (``PGOAgent.cpp:250-288``):

        T_world2_world1 = T_world2_frame2 . T_frame1_frame2^-1 . T_world1_frame1^-1

    with frame1 b's endpoint pose (b's local trajectory) and frame2 a's
    (already global).  Returns ``(Rs [k, d, d], ts [k, d])``, float64."""
    meas = part.meas
    d = meas.d
    r1 = np.asarray(meas.r1)
    r2 = np.asarray(meas.r2)
    Rs, ts = [], []
    for k in np.nonzero(((r1 == a) & (r2 == b)) | ((r1 == b) & (r2 == a)))[0]:
        dT = _se(np.asarray(meas.R[k]), np.asarray(meas.t[k]), d)
        if int(r1[k]) == a:  # incoming edge a -> b
            T_f1_f2 = _se_inv(dT, d)
            p_b, p_a = int(meas.p2[k]), int(meas.p1[k])
        else:                # outgoing edge b -> a
            T_f1_f2 = dT
            p_b, p_a = int(meas.p1[k]), int(meas.p2[k])
        T_w2_f2 = _se(T_global[a, p_a, :, :d], T_global[a, p_a, :, d], d)
        T_w1_f1 = _se(T_local[b, p_b, :, :d], T_local[b, p_b, :, d], d)
        T = T_w2_f2 @ _se_inv(T_f1_f2, d) @ _se_inv(T_w1_f1, d)
        Rs.append(T[:d, :d])
        ts.append(T[:d, d])
    return np.stack(Rs), np.stack(ts)


def robust_frame_alignment(Rs: np.ndarray, ts: np.ndarray, *,
                           two_stage: bool = True,
                           rotation_threshold_rad: float = 0.5,
                           device="cuda"):
    """Robust average of candidate transforms -> ``(R, t, num_inliers)``,
    computed on ``device`` in the candidates' dtype.

    Two-stage (default): GNC rotation averaging at a ~30 degree chordal
    threshold, then translation averaging over the rotation inliers
    (``computeRobustNeighborTransformTwoStage``, ``PGOAgent.cpp:290-331``).
    Single-stage: joint robust SE(d) averaging with the reference's
    kappa = 1.82, tau = 0.01 and a chi2(0.9, 3) threshold
    (``computeRobustNeighborTransform``, ``PGOAgent.cpp:333-367``)."""
    dev = resolve_device(device)
    Rs_t = torch.as_tensor(np.asarray(Rs), device=dev)
    ts_t = torch.as_tensor(np.asarray(ts), device=dev)
    if two_stage:
        thr = angular_to_chordal_so3(rotation_threshold_rad)
        rot = averaging.robust_single_rotation_averaging(
            Rs_t, error_threshold=thr)
        inl = rot.inlier_mask.to(Rs_t.dtype)
        t = averaging.single_translation_averaging(ts_t, mask=inl)
        return (rot.R.cpu().numpy(), t.cpu().numpy(),
                int(rot.inlier_mask.sum()))
    k = Rs_t.shape[0]
    res = averaging.robust_single_pose_averaging(
        Rs_t, ts_t, kappa=torch.full((k,), 1.82, dtype=Rs_t.dtype,
                                     device=dev),
        tau=torch.full((k,), 0.01, dtype=Rs_t.dtype, device=dev),
        error_threshold=error_threshold_at_quantile(0.9, 3))
    return (res.R.cpu().numpy(), res.t.cpu().numpy(),
            int(res.inlier_mask.sum()))


def distributed_initialization(
    part: Partition,
    meta: GraphMeta,
    graph: MultiAgentGraph,
    params: AgentParams,
    dtype=torch.float64,
    two_stage: bool = True,
) -> torch.Tensor:
    """Initial lifted state ``X0 [A, n_max, r, d+1]`` on the graph's device
    without any centralized solve — the deployment initialization.

    Robot 0's local frame is the global frame (``PGOAgent.cpp:182-186``);
    the other robots align in BFS order from robot 0.  A robot prefers the
    initialized neighbor sharing the most edges and falls back to others
    when GNC finds fewer than ``params.robust_init_min_inliers`` inliers
    (the retry of ``PGOAgent.cpp:396-400``); if every neighbor fails, the
    best-connected neighbor's candidates are averaged unweighted (with a
    warning) so the solve can proceed — RBCD corrects moderate
    misalignment."""
    dev = graph.global_index.device
    A = part.num_robots
    d = part.meas.d
    min_inliers = max(1, params.robust_init_min_inliers)

    T_local = local_initialization(part, params, dtype, dev)
    T_global = np.array(T_local)

    # Robot adjacency weighted by shared-edge counts.
    r1 = np.asarray(part.meas.r1)
    r2 = np.asarray(part.meas.r2)
    n_shared = np.zeros((A, A), np.int64)
    for k in np.nonzero(r1 != r2)[0]:
        n_shared[r1[k], r2[k]] += 1
        n_shared[r2[k], r1[k]] += 1

    initialized = {0}
    while len(initialized) < A:
        # Next robot: most shared edges into the initialized set (the
        # robots the reference would reach first).
        frontier = [
            (int(n_shared[b, list(initialized)].sum()), b)
            for b in range(A) if b not in initialized
        ]
        weight, b = max(frontier)
        if weight == 0:
            raise ValueError(
                f"robot {b} shares no edges with the initialized component; "
                "the robot-level pose graph is disconnected")
        neighbors = sorted((a for a in initialized if n_shared[b, a] > 0),
                           key=lambda a: -n_shared[b, a])
        best = None  # (num_inliers, R, t)
        for a in neighbors:
            Rs, ts = _alignment_candidates(part, T_local, T_global, b, a)
            R, t, ninl = robust_frame_alignment(Rs, ts, two_stage=two_stage,
                                                device=dev)
            if best is None or ninl > best[0]:
                best = (ninl, R, t)
            if ninl >= min_inliers:
                break
        ninl, R, t = best
        if 0 < ninl < min_inliers:
            # A usable robust estimate on fewer inliers than requested: the
            # reference accepts any non-empty inlier set (PGOAgent.cpp:
            # 396-400 aborts only on zero).
            warnings.warn(
                f"[dist_init] robot {b}: robust alignment found only "
                f"{ninl} inlier(s) (< {min_inliers}); using them")
        elif ninl == 0:
            # Every neighbor's GNC rejected everything: unweighted averaging
            # over the best-connected neighbor's candidates keeps the solve
            # going, but outliers may poison the estimate.
            a = neighbors[0]
            Rs, ts = _alignment_candidates(part, T_local, T_global, b, a)
            R, t = averaging.single_pose_averaging(
                torch.as_tensor(Rs, device=dev),
                torch.as_tensor(ts, device=dev))
            R, t = R.cpu().numpy(), t.cpu().numpy()
            warnings.warn(
                f"[dist_init] robot {b}: robust alignment found NO inliers "
                f"against any initialized neighbor; falling back to "
                f"unweighted averaging over {len(Rs)} candidates")
        # T_global_pose = T_align . T_local_pose for the whole trajectory
        # (initializeInGlobalFrame, PGOAgent.cpp:402-419).
        n_b = int(part.n[b])
        Rl = T_local[b, :n_b, :, :d]
        tl = T_local[b, :n_b, :, d]
        T_global[b, :n_b, :, :d] = np.einsum("ab,nbc->nac", R, Rl)
        T_global[b, :n_b, :, d] = tl @ R.T + t
        initialized.add(b)

    # Lift: X = YLift . T per pose (PGOAgent.cpp:415), batched.
    ylift = lifting_matrix(meta, dtype, dev)
    flat = torch.as_tensor(T_global.reshape(-1, d, d + 1), dtype=dtype,
                           device=dev)
    X0 = lift(flat, ylift).reshape(A, part.n_max, meta.rank, d + 1)
    return X0 * graph.pose_mask.to(dtype)[:, :, None, None]

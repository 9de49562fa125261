"""Synthetic pose graphs (numpy), the port's copy of
``dpgo_tpu.utils.synthetic``: ``make_measurements``, the loop-closure
corruption protocols (independent and correlated), the stitched-winding
saddle of the certificate tests and the rejection scores.  For the same ``np.random.default_rng`` state both packages draw
the same stream and return bit-identical measurements (the batched
``make_measurements_vectorized`` too)."""

import numpy as np

from ..types import Measurements, loop_closure_mask
from . import lie


def _project_rotations_np(M: np.ndarray) -> np.ndarray:
    """Batched numpy SO(d) projection (SVD with det fix)."""
    U, _, Vh = np.linalg.svd(M)
    det = np.linalg.det(U @ Vh)
    U[det < 0, :, -1] *= -1.0
    return U @ Vh


def random_rotation(rng, d=3):
    return _project_rotations_np(rng.standard_normal((d, d))[None])[0]


def random_trajectory(rng, n, d=3, step=1.0):
    """Ground-truth poses: random rotations, random-walk translations,
    pose 0 anchored at the identity."""
    Rs = _project_rotations_np(rng.standard_normal((n, d, d)))
    ts = np.cumsum(step * rng.standard_normal((n, d)), axis=0)
    R0inv = Rs[0].T
    ts = (ts - ts[0]) @ R0inv.T
    Rs = np.einsum("ab,nbc->nac", R0inv, Rs)
    return Rs, ts


def relative_measurement(Rs, ts, i, j, rng=None, rot_noise=0.0,
                         trans_noise=0.0, d=3):
    """Relative measurement i -> j: R = R_i^T R_j, t = R_i^T (t_j - t_i),
    with optional axis-angle rotation and Gaussian translation noise."""
    R = Rs[i].T @ Rs[j]
    t = Rs[i].T @ (ts[j] - ts[i])
    if rng is not None and rot_noise > 0:
        axis = rng.standard_normal(3 if d == 3 else 1)
        if d == 3:
            axis /= np.linalg.norm(axis)
            ang = rng.normal(0, rot_noise)
            q = np.concatenate([np.sin(ang / 2) * axis, [np.cos(ang / 2)]])
            R = lie.quat_to_rotation(q) @ R
        else:
            R = np.asarray(lie.rotation2d(rng.normal(0, rot_noise))) @ R
    if rng is not None and trans_noise > 0:
        t = t + rng.normal(0, trans_noise, d)
    return R, t


def make_measurements(rng, n, d=3, num_lc=5, rot_noise=0.0, trans_noise=0.0,
                      kappa=100.0, tau=10.0, outlier_lc=0):
    """Odometry chain + random loop closures (+ optional gross outliers).
    Returns ``(meas, (Rs, ts))`` with the ground truth."""
    Rs, ts = random_trajectory(rng, n, d)
    edges = [(i, i + 1) for i in range(n - 1)]
    seen = set(edges)
    while len(edges) < (n - 1) + num_lc:
        i, j = sorted(rng.choice(n, 2, replace=False))
        if j > i + 1 and (i, j) not in seen:
            edges.append((int(i), int(j)))
            seen.add((int(i), int(j)))
    Rm, tm = [], []
    for (i, j) in edges:
        R, t = relative_measurement(Rs, ts, i, j, rng, rot_noise,
                                    trans_noise, d)
        Rm.append(R)
        tm.append(t)
    while outlier_lc > 0:
        i, j = sorted(rng.choice(n, 2, replace=False))
        if j <= i + 1:
            continue
        edges.append((int(i), int(j)))
        Rm.append(random_rotation(rng, d))
        tm.append(5.0 * rng.standard_normal(d))
        outlier_lc -= 1
    m = len(edges)
    e = np.asarray(edges)
    meas = Measurements(
        d=d, num_poses=n,
        r1=np.zeros(m, np.int32), p1=e[:, 0].astype(np.int64),
        r2=np.zeros(m, np.int32), p2=e[:, 1].astype(np.int64),
        R=np.stack(Rm), t=np.stack(tm),
        kappa=np.full(m, kappa), tau=np.full(m, tau),
        weight=np.ones(m), is_known_inlier=np.zeros(m, bool),
    )
    return meas, (Rs, ts)


def _quats_to_rotations_np(q: np.ndarray) -> np.ndarray:
    """Batched unit quaternion (x, y, z, w) -> rotation matrix [n, 3, 3]
    (vectorized twin of ``lie.quat_to_rotation``)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((q.shape[0], 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _random_rotations_np(rng, n: int, d: int) -> np.ndarray:
    """n uniform random rotations, fully vectorized (quaternions for
    SO(3), angles for SO(2)) — no per-pose SVD, so million-pose
    trajectories synthesize in seconds."""
    if d == 3:
        q = rng.standard_normal((n, 4))
        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        return _quats_to_rotations_np(q)
    th = rng.uniform(0.0, 2.0 * np.pi, n)
    c, s = np.cos(th), np.sin(th)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=1)


def _rotation_noise_np(rng, n: int, d: int, sigma: float) -> np.ndarray:
    """n small random rotations (axis-angle, angle ~ N(0, sigma)),
    vectorized — the noise model of ``relative_measurement``."""
    ang = rng.normal(0.0, sigma, n)
    if d == 2:
        c, s = np.cos(ang), np.sin(ang)
        return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)],
                        axis=1)
    axis = rng.standard_normal((n, 3))
    axis /= np.maximum(np.linalg.norm(axis, axis=1, keepdims=True), 1e-12)
    q = np.concatenate([np.sin(ang / 2)[:, None] * axis,
                        np.cos(ang / 2)[:, None]], axis=1)
    return _quats_to_rotations_np(q)


def make_measurements_vectorized(rng, n, d=3, num_lc=5, rot_noise=0.0,
                                 trans_noise=0.0, kappa=100.0, tau=10.0):
    """``make_measurements`` without the per-edge Python loop: odometry
    chain + random loop closures assembled entirely from batched numpy.

    For pod-scale problems: the looped generator synthesizes ~1e4
    edges/s, which turns a 1M-pose / 1M-edge problem into a multi-minute
    build before the solver even starts; this one does the same
    construction in a handful of batched ops.  Same measurement model (exact relative transforms plus optional
    axis-angle rotation noise and Gaussian translation noise), not
    edge-for-edge identical to the looped generator's RNG stream."""
    Rs = _random_rotations_np(rng, n, d)
    ts = np.cumsum(rng.standard_normal((n, d)), axis=0)
    R0inv = Rs[0].T
    ts = (ts - ts[0]) @ R0inv.T
    Rs = np.einsum("ab,nbc->nac", R0inv, Rs)

    i_odo = np.arange(n - 1)
    j_odo = i_odo + 1
    if num_lc > 0:
        # Oversample, keep i + 1 < j, dedupe — vectorized rejection.
        cand = rng.integers(0, n, (4 * num_lc + 64, 2))
        lo, hi = cand.min(1), cand.max(1)
        keep = hi > lo + 1
        pairs = np.unique(np.stack([lo[keep], hi[keep]], -1), axis=0)
        take = rng.permutation(pairs.shape[0])[:num_lc]
        i_lc, j_lc = pairs[take, 0], pairs[take, 1]
    else:
        i_lc = j_lc = np.zeros(0, np.int64)
    ei = np.concatenate([i_odo, i_lc])
    ej = np.concatenate([j_odo, j_lc])
    m = ei.shape[0]

    # R = R_i^T R_j, t = R_i^T (t_j - t_i), batched.
    Ri = Rs[ei]
    Rm = np.einsum("eba,ebc->eac", Ri, Rs[ej])
    tm = np.einsum("eba,eb->ea", Ri, ts[ej] - ts[ei])
    if rot_noise > 0:
        Rm = np.einsum("eab,ebc->eac", _rotation_noise_np(rng, m, d,
                                                          rot_noise), Rm)
    if trans_noise > 0:
        tm = tm + rng.normal(0.0, trans_noise, (m, d))

    return Measurements(
        d=d, num_poses=n,
        r1=np.zeros(m, np.int32), p1=ei.astype(np.int64),
        r2=np.zeros(m, np.int32), p2=ej.astype(np.int64),
        R=Rm, t=tm,
        kappa=np.full(m, kappa), tau=np.full(m, tau),
        weight=np.ones(m), is_known_inlier=np.zeros(m, bool),
    ), (Rs, ts)


def corrupt_loop_closures(meas: Measurements, fraction: float, rng=None,
                          seed: int = 0):
    """Replace a random ``fraction`` of the loop closures with gross
    outliers (the GNC-paper corruption protocol).

    The reference's GNC machinery (``src/DPGO_robust.cpp:23-103``,
    ``src/PGOAgent.cpp:1181-1245``) exists to survive corrupted loop
    closures, but its repo ships no corrupted datasets or injection
    protocol — this is the standard one used by the robust-PGO
    literature: keep odometry trusted, pick round(fraction * num_lc)
    loop closures uniformly at random, and overwrite each with a
    uniformly random rotation and a random translation at the scale of
    the trajectory's own extent (so the outliers are gross but not
    astronomically out of distribution; precisions are kept, as the
    corrupted edge still CLAIMS the dataset noise model).

    ``meas`` must be globally indexed (as from ``read_g2o``).  Returns
    ``(corrupted, outlier_idx)`` where ``outlier_idx`` are the global
    measurement indices that were overwritten — the ground truth for
    precision/recall scoring of GNC edge rejection.
    """
    rng = rng or np.random.default_rng(seed)
    d = meas.d
    lc_idx = np.flatnonzero(loop_closure_mask(meas))
    k = int(round(fraction * lc_idx.size))
    outlier_idx = np.sort(rng.choice(lc_idx, size=k, replace=False))

    out = meas.select(np.arange(len(meas)))  # fancy indexing copies every field
    out.weight = np.ones(len(meas))
    if k:
        out.R[outlier_idx] = _project_rotations_np(
            rng.standard_normal((k, d, d)))
        # Translation scale from the data itself: outlier norms uniform in
        # [0, 2 * the 95th-percentile measured translation norm].
        scale = 2.0 * float(np.percentile(np.linalg.norm(meas.t, axis=1), 95))
        dirs = rng.standard_normal((k, d))
        dirs /= np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-12)
        out.t[outlier_idx] = dirs * rng.uniform(0.0, scale, (k, 1))
    return out, outlier_idx


def integrate_odometry_np(meas: Measurements):
    """Dead-reckoned world poses from the odometry chain (global indexing):
    ``X_{p+1} = X_p * meas_{p->p+1}``.  The pose estimates a front-end
    would hold — and therefore the frame in which perceptually-aliased
    loop closures are self-consistent."""
    d = meas.d
    n = meas.num_poses
    Rs = np.zeros((n, d, d))
    ts = np.zeros((n, d))
    Rs[0] = np.eye(d)
    odo = {}
    same = meas.r1 == meas.r2
    for k in np.flatnonzero(same & (meas.p2 == meas.p1 + 1)):
        odo[int(meas.p1[k])] = k
    for p in range(n - 1):
        k = odo.get(p)
        if k is None:  # gap in the chain: restart at identity (rare)
            Rs[p + 1] = np.eye(d)
            ts[p + 1] = ts[p]
            continue
        Rs[p + 1] = Rs[p] @ meas.R[k]
        ts[p + 1] = ts[p] + Rs[p] @ meas.t[k]
    return Rs, ts


def corrupt_loop_closures_correlated(
    meas: Measurements, fraction: float, clusters: int | None = None,
    rng=None, seed: int = 0, rot_noise: float = 0.005,
    trans_noise: float = 0.01, min_separation_frac: float = 0.1,
):
    """Perceptual-aliasing corruption: clusters of MUTUALLY CONSISTENT
    false loop closures (the hard case).

    ``corrupt_loop_closures`` injects independent uniform-random gross
    edges — the regime GNC-TLS provably crushes (measured recall 1.000 at
    every level).  The failure mode that actually breaks single-anneal
    GNC in the robust-SLAM literature is CORRELATED: a front-end that
    aliases two similar-looking places emits a whole cluster of loop
    closures, all consistent with ONE wrong relative transform between
    two trajectory segments.  Inside the cluster the edges corroborate
    each other, so per-edge residual tests can lock onto the wrong mode.

    Protocol: round(fraction * num_lc) false edges split into
    ``clusters`` groups (default: ~15 edges each).  Each group picks two
    well-separated same-length segments [a, a+m) and [b, b+m) of the
    dead-reckoned trajectory (``integrate_odometry_np``), draws one
    gross transform ``T`` (uniform random rotation, translation at the
    trajectory scale), and overwrites m existing loop closures with
    edges (a+i) -> (b+i) whose measurements are exactly consistent with
    "segment B sits at T relative to segment A" plus small i.i.d. noise
    — i.e. ``R_meas = R_a^T (R_T R_b)``, ``t_meas = R_a^T (R_T t_b +
    t_T - t_a)`` in the dead-reckoned frame.  Precisions are kept
    (the false edges claim the dataset's own noise model).

    Returns ``(corrupted, outlier_idx)`` like ``corrupt_loop_closures``.
    Reference machinery under test: ``src/DPGO_robust.cpp:23-103``,
    ``src/PGOAgent.cpp:1181-1245``.
    """
    rng = rng or np.random.default_rng(seed)
    d = meas.d
    n = meas.num_poses
    lc_idx = np.flatnonzero(loop_closure_mask(meas))
    k_total = int(round(fraction * lc_idx.size))
    if clusters is None:
        clusters = max(1, k_total // 15)
    clusters = min(clusters, max(1, k_total))
    outlier_idx = np.sort(rng.choice(lc_idx, size=k_total, replace=False))

    Rs, ts = integrate_odometry_np(meas)
    extent = 2.0 * float(np.percentile(np.linalg.norm(meas.t, axis=1), 95))
    min_sep = int(min_separation_frac * n)

    out = meas.select(np.arange(len(meas)))
    out.weight = np.ones(len(meas))
    sizes = np.full(clusters, k_total // clusters)
    sizes[: k_total - sizes.sum()] += 1
    pos = 0
    for c in range(clusters):
        m = int(sizes[c])
        if m == 0:
            continue
        for _ in range(200):  # rejection-sample well-separated segments
            a = int(rng.integers(0, n - m))
            b = int(rng.integers(0, n - m))
            if abs(a - b) >= max(min_sep, m):
                break
        else:
            # Unsatisfiable geometry (cluster size ~ graph size): falling
            # through would silently create overlapping or self-loop
            # segments, breaking the two-distinct-places invariant the
            # aliasing protocol models.
            raise ValueError(
                f"cannot place two disjoint segments of {m} poses "
                f">= {max(min_sep, m)} apart in a {n}-pose graph; "
                "reduce fraction or increase clusters")
        R_T = random_rotation(rng, d)
        t_T = rng.standard_normal(d)
        t_T *= rng.uniform(0.3, 1.0) * extent / max(np.linalg.norm(t_T),
                                                    1e-12)
        rows = outlier_idx[pos:pos + m]
        pos += m
        for i, row in enumerate(rows):
            ia, ib = a + i, b + i
            Rb = R_T @ Rs[ib]
            tb = R_T @ ts[ib] + t_T
            Rm = Rs[ia].T @ Rb
            tm = Rs[ia].T @ (tb - ts[ia])
            # Small in-cluster noise so edges corroborate, not duplicate.
            Rm = _project_rotations_np(
                (Rm + rot_noise * rng.standard_normal((d, d)))[None])[0]
            tm = tm + trans_noise * rng.standard_normal(d)
            out.p1[row], out.p2[row] = ia, ib  # r1/r2 stay 0 (global ids)
            out.R[row] = Rm
            out.t[row] = tm
            out.is_known_inlier[row] = False  # aliasing is never "known"
    return out, outlier_idx


def make_stitched_winding(n_cycles: int, cycle_len: int,
                          kappa: float = 10.0, tau: float = 1.0,
                          bridge_kappa: float = 10.0, windings: int = 2):
    """An SE(2) dataset with a certifiably suboptimal rank-2 critical
    point, and that point as an iterate.

    ``n_cycles`` identity-measurement cycles of length ``cycle_len`` (the
    global optimum is all-identity at cost 0, but the winding
    configuration ``R_k = rot(2 pi w k / L)`` is a local minimum of the
    rank-2 problem while the per-step angle stays below pi/2), stitched
    pose 0 to pose 0: consecutive cycles by a chain bridge and each cycle
    from the third on to one random earlier cycle (``rng(7)``), so the
    cycle-quotient graph is an expander and the near-zero spectrum stays
    the gauge.  Bridges vanish at the wound configuration (pose 0 of every
    cycle is the identity there), which stays exactly critical.  The
    default ``windings=2`` is contractible at rank 3, so one saddle
    escape leads down to the global optimum.

    Returns ``(meas, X_winding [N, 2, 3])``."""
    n = n_cycles * cycle_len
    e_i, e_j, kap = [], [], []
    rng_b = np.random.default_rng(7)
    for c in range(n_cycles):
        base = c * cycle_len
        for k in range(cycle_len):
            e_i.append(base + k)
            e_j.append(base + (k + 1) % cycle_len)
            kap.append(kappa)
        if c + 1 < n_cycles:
            e_i.append(base)
            e_j.append(base + cycle_len)
            kap.append(bridge_kappa)
        if c >= 2:
            e_i.append(base)
            e_j.append(int(rng_b.integers(0, c - 1)) * cycle_len)
            kap.append(bridge_kappa)
    m = len(e_i)
    meas = Measurements(
        d=2, num_poses=n,
        r1=np.zeros(m, np.int32), p1=np.asarray(e_i, np.int64),
        r2=np.zeros(m, np.int32), p2=np.asarray(e_j, np.int64),
        R=np.tile(np.eye(2), (m, 1, 1)), t=np.zeros((m, 2)),
        kappa=np.asarray(kap, float), tau=np.full(m, tau),
        weight=np.ones(m), is_known_inlier=np.zeros(m, bool),
    )
    th = 2 * np.pi * windings * (np.arange(n) % cycle_len) / cycle_len
    Rw = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                   np.stack([np.sin(th), np.cos(th)], -1)], -2)
    Xw = np.concatenate([Rw, np.zeros((n, 2, 1))], axis=-1)
    return meas, Xw


def rejection_scores(weights: np.ndarray, meas: Measurements,
                     outlier_idx: np.ndarray, thresh: float = 0.5):
    """Precision/recall of GNC edge rejection against injected ground truth.

    ``weights`` are final per-measurement GNC weights ([M], as in
    ``RBCDResult.weights``); an edge is *rejected* when its weight falls
    below ``thresh``.  ALL edges count, not just the global loop-closure
    mask: interior odometry keeps weight 1 by construction, but
    globally-consecutive edges that span a robot boundary are shared
    edges the solver CAN reweight (``types.loop_closure_mask`` note) —
    a false rejection there must count against precision.
    Returns ``(precision, recall, n_rejected)``.
    """
    rejected = np.asarray(weights) < thresh
    truth = np.zeros(len(meas), bool)
    truth[outlier_idx] = True
    tp = int(np.sum(rejected & truth))
    n_rej = int(np.sum(rejected))
    precision = tp / n_rej if n_rej else 1.0
    recall = tp / truth.sum() if truth.any() else 1.0
    return precision, recall, n_rej


def trajectory_error(T, Rs, ts):
    """Max pose error of T [n, d, d+1] vs ground truth, after aligning
    pose 0 (gauge).  ``T`` may be a tensor (read to the host)."""
    if hasattr(T, "detach"):
        T = T.detach().cpu().numpy()
    d = Rs.shape[-1]
    R_est = np.asarray(T[..., :d])
    t_est = np.asarray(T[..., d])
    # Align: G = pose0_true * pose0_est^{-1}
    Rg = Rs[0] @ R_est[0].T
    tg = ts[0] - Rg @ t_est[0]
    R_al = np.einsum("ab,nbc->nac", Rg, R_est)
    t_al = t_est @ Rg.T + tg
    return max(
        float(np.abs(R_al - Rs).max()),
        float(np.abs(t_al - ts).max()),
    )

"""Synthetic pose graphs (numpy), the port's copy of
``dpgo_tpu.utils.synthetic.make_measurements``: for the same
``np.random.default_rng`` state both packages draw the same stream and
return bit-identical measurements."""

import numpy as np

from ..types import Measurements
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


"""The port's distributed initialization (``dpgo_tpu_torch.models.
dist_init``, ``rbcd.solve_rbcd(init="distributed")``) against the JAX
package's (``dpgo_tpu.models.dist_init``), in float64 on the CPU, on the
same synthetic problems (the generators are bitwise equal, and the
corrupted problems are built once and handed to both).

Each case of ``tests/test_dist_init.py`` but the kitti one (it needs the
dataset) has a counterpart.  Tolerances: the local inits and X0 at rtol
1e-9; the alignment order, the candidates, the inlier counts, the warnings
and the disconnected ``ValueError`` identical; the solves' iterations and
reasons equal and their histories at rtol 1e-9, as the other rbcd tests
hold them.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.config import RobustCostParams as JRobustCostParams
from dpgo_tpu.config import RobustCostType as JRobustCostType
from dpgo_tpu.config import SolverParams as JSolverParams
from dpgo_tpu.models import dist_init as jdist
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import (make_measurements, random_rotation,
                                      trajectory_error)
from dpgo_tpu_torch.config import (AgentParams, RobustCostParams,
                                   RobustCostType, Schedule, SolverParams)
from dpgo_tpu_torch.models import dist_init, rbcd
from dpgo_tpu_torch.types import Measurements
from dpgo_tpu_torch.utils.partition import Partition


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread, not a pool spinning on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tmeas(m) -> Measurements:
    return Measurements(**{f.name: getattr(m, f.name)
                           for f in dataclasses.fields(Measurements)})


def _tpart(part) -> Partition:
    return Partition(num_robots=part.num_robots, meas=_tmeas(part.meas),
                     n=part.n, global_index=part.global_index,
                     meas_global=_tmeas(part.meas_global))


def _both(part, A, r=5, **pkw):
    """Both packages' graphs, metas and params for one partition."""
    jp = JAgentParams(d=3, r=r, num_robots=A, **pkw)
    tp = AgentParams(d=3, r=r, num_robots=A, **pkw)
    jg, jm = jrbcd.build_graph(part, r, jnp.float64)
    tpart = _tpart(part)
    tg, tm = rbcd.build_graph(tpart, r, torch.float64, device="cpu")
    return jp, tp, jg, jm, tpart, tg, tm


def _recording(module, monkeypatch):
    """Record every ``robust_frame_alignment`` call of ``module``: the
    candidates and the inlier count, in call order."""
    calls = []
    orig = module.robust_frame_alignment

    def rec(Rs, ts, **kw):
        out = orig(Rs, ts, **kw)
        calls.append((np.asarray(Rs), np.asarray(ts), out[2]))
        return out
    monkeypatch.setattr(module, "robust_frame_alignment", rec)
    return calls


def _init_both(part, A, monkeypatch, **pkw):
    jp, tp, jg, jm, tpart, tg, tm = _both(part, A, **pkw)
    jcalls = _recording(jdist, monkeypatch)
    tcalls = _recording(dist_init, monkeypatch)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        Xj = np.asarray(jdist.distributed_initialization(part, jm, jg, jp))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        Xt = dist_init.distributed_initialization(tpart, tm, tg, tp)
    assert Xt.dtype == torch.float64 and Xt.device.type == "cpu"
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=1e-9, atol=1e-12)
    assert [c[2] for c in tcalls] == [c[2] for c in jcalls]
    for (tR, tt, _), (jR, jt, _) in zip(tcalls, jcalls):
        np.testing.assert_allclose(tR, jR, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tt, jt, rtol=1e-9, atol=1e-12)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    return Xt, tg, tm, tcalls, [str(w.message) for w in tw]


def _trajectory(X, graph, meta, n):
    Xg = rbcd.gather_to_global(X, graph, n)
    return rbcd.round_global(Xg, rbcd.lifting_matrix(meta, torch.float64,
                                                     "cpu")).numpy()


@pytest.mark.parametrize("robust", [False, True])
def test_local_initialization_per_agent_frames(rng, robust):
    """Chordal local inits under L2, odometry under a robust cost (the
    reference's ``localInitialization`` policy)."""
    meas, _ = make_measurements(rng, n=24, d=3, num_lc=8,
                                rot_noise=0.02 if robust else 0.0,
                                trans_noise=0.02 if robust else 0.0)
    part = jpartition(meas, 4)
    kw = dict(robust=RobustCostParams(cost_type=RobustCostType.GNC_TLS)) \
        if robust else {}
    jkw = dict(robust=JRobustCostParams(
        cost_type=JRobustCostType.GNC_TLS)) if robust else {}
    T = dist_init.local_initialization(
        _tpart(part), AgentParams(d=3, r=5, num_robots=4, **kw),
        device="cpu")
    Tj = jdist.local_initialization(
        part, JAgentParams(d=3, r=5, num_robots=4, **jkw))
    assert T.shape == (4, part.n_max, 3, 4)
    np.testing.assert_allclose(T, Tj, rtol=1e-9, atol=1e-12)
    for a in range(4):
        assert np.allclose(T[a, 0, :, :3], np.eye(3), atol=1e-6)
        assert np.allclose(T[a, 0, :, 3], 0.0, atol=1e-6)


def test_distributed_init_aligns_frames(rng, monkeypatch):
    meas, (Rs, ts) = make_measurements(rng, n=24, d=3, num_lc=10)
    part = jpartition(meas, 4)
    X0, tg, tm, calls, warned = _init_both(part, 4, monkeypatch)
    assert len(calls) == 3 and not warned
    assert trajectory_error(_trajectory(X0, tg, tm, meas.num_poses),
                            Rs, ts) < 1e-6


def _corrupt_shared(part, rng, every):
    r1, r2 = np.asarray(part.meas.r1), np.asarray(part.meas.r2)
    shared = np.nonzero(r1 != r2)[0]
    R_new = np.array(part.meas.R)
    t_new = np.array(part.meas.t)
    for k in shared[::every]:
        R_new[k] = random_rotation(rng, 3)
        t_new[k] = 10.0 * rng.standard_normal(3)
    meas_bad = dataclasses.replace(part.meas, R=R_new, t=t_new)
    return dataclasses.replace(part, meas=meas_bad), shared


def test_distributed_init_robust_to_outlier_shared_edges(rng, monkeypatch):
    meas, (Rs, ts) = make_measurements(rng, n=32, d=3, num_lc=24)
    part, shared = _corrupt_shared(jpartition(meas, 4), rng, 3)
    assert len(shared) >= 6
    X0, tg, tm, calls, _ = _init_both(part, 4, monkeypatch)
    # Some candidates were rejected, and the frames still align exactly.
    assert sum(len(c[0]) - c[2] for c in calls) > 0
    assert trajectory_error(_trajectory(X0, tg, tm, meas.num_poses),
                            Rs, ts) < 1e-6


def test_distributed_init_warnings_match(rng, monkeypatch):
    """The fallbacks and their warnings: too few inliers for
    ``robust_init_min_inliers`` ("only N inlier(s)"), and every shared edge
    corrupted ("NO inliers", unweighted averaging)."""
    meas, _ = make_measurements(rng, n=24, d=3, num_lc=10)
    part = jpartition(meas, 4)
    _, _, _, calls, warned = _init_both(part, 4, monkeypatch,
                                        robust_init_min_inliers=100)
    assert len(warned) == 3 and all("inlier(s)" in w for w in warned)
    # Every neighbor was tried before the fallback took the best.
    assert len(calls) >= 3
    # Two robots sharing two edges, both corrupted: two candidates far
    # apart sit at the same distance from their average, and GNC drops
    # both.
    meas, _ = make_measurements(rng, n=12, d=3, num_lc=0)
    lc = meas.select(np.array([0]))
    lc = dataclasses.replace(lc, p1=np.array([2]), p2=np.array([9]))
    meas = dataclasses.replace(meas, **{
        f: np.concatenate([getattr(meas, f), getattr(lc, f)])
        for f in ("r1", "p1", "r2", "p2", "R", "t", "kappa", "tau", "weight",
                  "is_known_inlier")})
    bad, shared = _corrupt_shared(jpartition(meas, 2), rng, 1)
    assert len(shared) == 2
    _, _, _, calls, warned = _init_both(bad, 2, monkeypatch)
    assert [c[2] for c in calls] == [0]
    assert len(warned) == 1 and "NO inliers" in warned[0]


def test_distributed_init_disconnected_raises(rng):
    meas, _ = make_measurements(rng, n=12, d=3, num_lc=0)
    part = jpartition(meas, 2)
    r1, r2 = np.asarray(part.meas.r1), np.asarray(part.meas.r2)
    keep = r1 == r2
    m = part.meas
    sub = dataclasses.replace(
        m, r1=m.r1[keep], p1=m.p1[keep], r2=m.r2[keep], p2=m.p2[keep],
        R=m.R[keep], t=m.t[keep], kappa=m.kappa[keep], tau=m.tau[keep],
        weight=m.weight[keep], is_known_inlier=m.is_known_inlier[keep])
    part2 = dataclasses.replace(part, meas=sub)
    jp, tp, jg, jm, tpart, tg, tm = _both(part2, 2)
    with pytest.raises(ValueError, match="disconnected") as jerr:
        jdist.distributed_initialization(part2, jm, jg, jp)
    with pytest.raises(ValueError, match="disconnected") as terr:
        dist_init.distributed_initialization(tpart, tm, tg, tp)
    assert str(terr.value) == str(jerr.value)


def test_robust_frame_alignment_single_stage_matches_jax(rng):
    """The single-stage form (joint SE(d) GNC, kappa 1.82, tau 0.01,
    chi2(0.9, 3)) and the two-stage form on the same candidates."""
    R = random_rotation(rng, 3)
    t = rng.standard_normal(3)
    Rs = np.stack([R] * 6 + [random_rotation(rng, 3) for _ in range(3)])
    ts = np.stack([t + 1e-3 * rng.standard_normal(3) for _ in range(6)]
                  + [10.0 * rng.standard_normal(3) for _ in range(3)])
    for two_stage in (True, False):
        tR, tt, tn = dist_init.robust_frame_alignment(
            Rs, ts, two_stage=two_stage, device="cpu")
        jR, jt, jn = jdist.robust_frame_alignment(Rs, ts,
                                                  two_stage=two_stage)
        assert tn == jn
        np.testing.assert_allclose(tR, np.asarray(jR), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(tt, np.asarray(jt), rtol=1e-9,
                                   atol=1e-12)
    assert dist_init._se_inv(dist_init._se(R, t, 3), 3) @ \
        dist_init._se(R, t, 3) == pytest.approx(np.eye(4))


def _solve_both(meas, params_kw, max_iters, grad_norm_tol, cost_atol=0.0,
                gn_atol=0.0):
    jp = JAgentParams(**params_kw["jax"])
    tp = AgentParams(**params_kw["torch"])
    ref = jrbcd.solve_rbcd(meas, 4, jp, max_iters=max_iters,
                           grad_norm_tol=grad_norm_tol, init="distributed")
    res = rbcd.solve_rbcd(_tmeas(meas), 4, tp, max_iters=max_iters,
                          grad_norm_tol=grad_norm_tol, init="distributed",
                          dtype=torch.float64, device="cpu")
    assert res.iterations == ref.iterations
    assert res.terminated_by == ref.terminated_by
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9, atol=cost_atol)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9,
                               atol=gn_atol)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(ref.weights),
                               rtol=1e-9, atol=1e-12)
    return res


def test_solve_rbcd_distributed_init_end_to_end(rng):
    meas, _ = make_measurements(rng, n=24, d=3, num_lc=10,
                                rot_noise=0.02, trans_noise=0.02)
    common = dict(d=3, r=5, num_robots=4, rel_change_tol=1e-8)
    res = _solve_both(meas, {
        "jax": dict(common, solver=JSolverParams(grad_norm_tol=1e-6)),
        "torch": dict(common, schedule=Schedule.JACOBI,
                      solver=SolverParams(grad_norm_tol=1e-6))},
        max_iters=150, grad_norm_tol=1e-4)
    assert res.grad_norm_history[-1] < 1e-4


def test_solve_rbcd_distributed_init_robust_odometry_start(rng):
    """GNC: the local inits are odometry; the solve rejects the outliers.
    The measurements are noiseless, so the cost falls to ~1e-11 and the
    gradient norm to ~1e-6, where the rounding of the iterates (~1e-16 per
    entry) moves them by ~1e-19 and ~1e-13: the histories also take an
    absolute 1e-18 (cost) and 1e-12 (gradient norm)."""
    meas, (Rs, ts) = make_measurements(rng, n=24, d=3, num_lc=10,
                                       outlier_lc=4)
    common = dict(d=3, r=5, num_robots=4, robust_opt_inner_iters=10,
                  rel_change_tol=1e-8)
    res = _solve_both(meas, {
        "jax": dict(common, robust=JRobustCostParams(
            cost_type=JRobustCostType.GNC_TLS, gnc_barc=0.5),
            solver=JSolverParams(grad_norm_tol=1e-6)),
        "torch": dict(common, robust=RobustCostParams(
            cost_type=RobustCostType.GNC_TLS, gnc_barc=0.5),
            solver=SolverParams(grad_norm_tol=1e-6))},
        max_iters=120, grad_norm_tol=1e-6, cost_atol=1e-18, gn_atol=1e-12)
    assert np.all(res.weights.numpy()[-4:] < 0.01)
    assert trajectory_error(res.T.numpy(), Rs, ts) < 1e-3

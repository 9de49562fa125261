"""The port's odometry init, iterated GNC and GNC on the gross-outlier
stand-in (``dpgo_tpu_torch.ops.chordal.odometry_from_edges``,
``models.rbcd.centralized_odometry_init``,
``models.rbcd.solve_rbcd_robust_iterated``) against the JAX package's, in
float64 on the CPU, and the copied synthetic helpers against the JAX
package's, bit for bit.

Tolerances: the odometry scan composes in the JAX package's association
order, so only the 3x3 products round differently (rtol 1e-10, atol 1e-12
for entries that cancel to ~0); whole solves at rtol 1e-9 as in the other
port tests; ``kept`` masks, iteration counts and GNC stages exactly.

Run as a script, the file makes the one-off full-size check of GNC on
``chip_smoke.py``'s stand-in (2500 poses, 50 gross outliers, float32):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_robust_iterated.py
"""

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu import robust as jrobust
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.ops import chordal as jchordal
from dpgo_tpu.types import edge_set_from_measurements as j_edges
from dpgo_tpu.utils import synthetic as jsyn
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch import robust as trobust
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import chordal
from dpgo_tpu_torch.types import edge_set_from_measurements as t_edges
from dpgo_tpu_torch.utils import synthetic as tsyn


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread, not a pool spinning on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meas(seed=42, n=60, num_lc=30, noise=0.02, outliers=0, pkg="torch"):
    mod = tsyn if pkg == "torch" else jsyn
    return mod.make_measurements(np.random.default_rng(seed), n=n, d=3,
                                 num_lc=num_lc, rot_noise=noise,
                                 trans_noise=noise, outlier_lc=outliers)[0]


# ---------------------------------------------------------------------------
# The odometry init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 8, 65, 300])
def test_odometry_from_edges_matches_jax(n):
    """Duplicates (a consecutive loop closure and a repeated odometry edge,
    where the odometry edge and then the first copy win) and a missing
    odometry edge (an identity step)."""
    meas = _meas(n=max(n, 4), num_lc=1, noise=0.05)
    N = meas.num_poses if n >= 4 else n
    rows = [k for k in range(len(meas)) if meas.p2[k] < N]
    drop = min(2, N - 2)
    rows = [k for k in rows if k != drop] + [rows[0], rows[-1]]
    sub = meas.select(np.asarray(rows))
    if N >= 4:  # a loop closure that looks consecutive, listed first
        lc = sub.select(np.asarray([1]))
        lc.R = np.eye(3)[None] * -1.0
        lc.t = np.full((1, 3), 9.0)
        lc.is_known_inlier = np.zeros(1, bool)
        sub = tsyn.Measurements(**{
            f: (getattr(sub, f) if f in ("d", "num_poses") else
                np.concatenate([getattr(lc, f), getattr(sub, f)]))
            for f in sub.__dataclass_fields__})
    et = t_edges(sub, dtype=torch.float64, device="cpu")
    et = et._replace(is_lc=torch.where(torch.arange(len(sub)) == 0, 1.0,
                                       et.is_lc))
    ej = j_edges(sub, dtype=jnp.float64)
    ej = ej._replace(is_lc=jnp.asarray(et.is_lc.numpy()))
    ref = np.asarray(jchordal.odometry_from_edges(ej, N))
    out = chordal.odometry_from_edges(et, N).numpy()
    assert out.shape == (N, 3, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-12)
    if N > 3:  # the missing edge gives an identity step
        np.testing.assert_allclose(out[drop + 1, :, :3], out[drop, :, :3],
                                   atol=1e-12)


def test_centralized_odometry_init_matches_jax():
    meas = _meas(n=40, num_lc=10)
    jp = jconfig.AgentParams(d=3, r=5, num_robots=3)
    jprob = jrbcd.prepare_problem(meas, 3, jp, dtype=jnp.float64,
                                  init="odometry")
    tprob = rbcd.prepare_problem(meas, 3, tconfig.AgentParams(
        d=3, r=5, num_robots=3), device="cpu", init="odometry")
    np.testing.assert_allclose(tprob.X0.numpy(), np.asarray(jprob.X0),
                               rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="unknown init policy"):
        rbcd.prepare_problem(meas, 3, device="cpu", init="bogus")


# ---------------------------------------------------------------------------
# Iterated GNC
# ---------------------------------------------------------------------------

def _iterated_params(mod):
    """The configuration of the JAX package's iterated-GNC test
    (tests/test_accel_robust.py)."""
    return mod.AgentParams(
        d=3, r=5, num_robots=4, schedule=mod.Schedule.COLORED,
        robust=mod.RobustCostParams(cost_type=mod.RobustCostType.GNC_TLS,
                                    gnc_barc=2.0),
        robust_opt_inner_iters=10, rel_change_tol=0.0,
        solver=mod.SolverParams(grad_norm_tol=1e-6))


@pytest.mark.parametrize("passes", [2, 3])
def test_robust_iterated_matches_jax(passes):
    clean = _meas(n=60, num_lc=30)
    meas, outlier_idx = tsyn.corrupt_loop_closures(clean, 0.4, seed=5)
    kw = dict(max_iters=400, grad_norm_tol=0.0, eval_every=100,
              init="odometry", verdict_every=100)
    jres, jw, jkept = jrbcd.solve_rbcd_robust_iterated(
        meas, 4, _iterated_params(jconfig), passes=passes,
        dtype=jnp.float64, **kw)
    res, w, kept = rbcd.solve_rbcd_robust_iterated(
        meas, 4, _iterated_params(tconfig), passes=passes,
        dtype=torch.float64, device="cpu", **kw)
    assert np.array_equal(kept, jkept)
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-9)
    assert tsyn.rejection_scores(w, meas, outlier_idx) == \
        jsyn.rejection_scores(jw, meas, outlier_idx)
    if passes == 3:  # reinstatement kept edges the hard drop lost
        assert not kept.all()


def test_robust_iterated_errors():
    meas = _meas(n=20, num_lc=5)
    gnc = _iterated_params(tconfig)
    with pytest.raises(ValueError, match="passes must be >= 1"):
        rbcd.solve_rbcd_robust_iterated(meas, 2, gnc, passes=0,
                                        device="cpu")
    with pytest.raises(ValueError, match="'part' cannot be supplied"):
        rbcd.solve_rbcd_robust_iterated(meas, 2, gnc, part=object(),
                                        device="cpu")
    with pytest.raises(ValueError, match="needs a GNC-weighted cost"):
        rbcd.solve_rbcd_robust_iterated(
            meas, 2, tconfig.AgentParams(d=3, r=5, num_robots=2),
            device="cpu")


@pytest.mark.parametrize("entry", [
    "dense_quadratic", "certify_round", "certify_epilogue",
    "distributed_init"])
def test_formerly_unported_entries_run(entry):
    """Each id names a part that once raised as not ported (the dense-Q
    round, a round with ``certify_mode`` set, the epilogue with the device
    certificate, the distributed init).  Each now runs: the rounds advance
    to a finite iterate, the epilogue returns ``cert``, and the init gives
    a finite lifted state."""
    meas = _meas(n=20, num_lc=5)
    prob = rbcd.prepare_problem(meas, 2, device="cpu")
    state = rbcd.init_state(prob.graph, prob.meta, prob.X0)

    def round_with(st=state, **kw):
        return rbcd.rbcd_step(st, prob.graph, prob.meta,
                              tconfig.AgentParams(d=3, r=5, num_robots=2,
                                                  **kw))

    if entry in ("dense_quadratic", "certify_round"):
        kw = dict(solver=tconfig.SolverParams(dense_quadratic=True)) \
            if entry == "dense_quadratic" else dict(certify_mode="host")
        st = state
        if entry == "dense_quadratic":
            st = rbcd.init_state(prob.graph, prob.meta, prob.X0,
                                 tconfig.AgentParams(d=3, r=5, num_robots=2,
                                                     **kw))
            assert st.Qbuf is not None
        out = round_with(st, **kw)
        assert out.iteration == 1 and bool(torch.isfinite(out.X).all())
        return
    if entry == "certify_epilogue":
        fin = rbcd.make_terminal_epilogue(
            prob.graph, rbcd._global_edges(prob.part, prob.graph,
                                           torch.float64),
            20, len(meas), prob.meta, certify_mode="device")(
                state.X, state.weights, {})
        assert {"T", "w_glob", "Xg", "cert"} <= set(fin)
        assert bool(torch.isfinite(fin["cert"]["lam_min"]))
        return
    dist = rbcd.prepare_problem(meas, 2, device="cpu", init="distributed")
    assert dist.X0.shape == prob.X0.shape
    assert bool(torch.isfinite(dist.X0).all())


# ---------------------------------------------------------------------------
# The copied synthetic helpers
# ---------------------------------------------------------------------------

def _assert_meas_equal(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        assert np.array_equal(np.asarray(x), np.asarray(y)), f


def test_synthetic_helpers_match_jax_bitwise():
    meas = _meas(n=200, num_lc=80)
    for frac, seed in ((0.3, 1), (0.0, 2)):
        a, ia = tsyn.corrupt_loop_closures(meas, frac, seed=seed)
        b, ib = jsyn.corrupt_loop_closures(meas, frac, seed=seed)
        _assert_meas_equal(a, b)
        assert np.array_equal(ia, ib)
    a, ia = tsyn.corrupt_loop_closures_correlated(meas, 0.25, clusters=2,
                                                  seed=3)
    b, ib = jsyn.corrupt_loop_closures_correlated(meas, 0.25, clusters=2,
                                                  seed=3)
    _assert_meas_equal(a, b)
    assert np.array_equal(ia, ib)
    for x, y in zip(tsyn.integrate_odometry_np(a),
                    jsyn.integrate_odometry_np(b)):
        assert np.array_equal(x, y)
    w = np.random.default_rng(4).uniform(0, 1, len(a))
    assert tsyn.rejection_scores(w, a, ia) == jsyn.rejection_scores(w, b, ib)
    with pytest.raises(ValueError, match="cannot place two disjoint"):
        tsyn.corrupt_loop_closures_correlated(_meas(n=12, num_lc=8), 1.0,
                                              clusters=1, seed=0)


# ---------------------------------------------------------------------------
# GNC on the gross-outlier stand-in (chip_smoke.py's schedules row)
# ---------------------------------------------------------------------------

def _standin_params(mod):
    """chip_smoke.py's COLORED + GNC_TLS configuration."""
    return mod.AgentParams(
        d=3, r=5, num_robots=8, schedule=mod.Schedule.COLORED,
        robust=mod.RobustCostParams(cost_type=mod.RobustCostType.GNC_TLS,
                                    gnc_barc=0.5),
        robust_opt_inner_iters=10, rel_change_tol=1e-8,
        solver=mod.SolverParams(grad_norm_tol=1e-6))


def gnc_standin(n: int, outliers: int, dtype: str,
                max_iters: int = 200, eval_every: int = 10,
                continued: bool = False) -> dict:
    """The stand-in (``make_measurements`` seed 0, noise 0.01, as many loop
    closures per pose as chip_smoke.py's 2449 of 2500, ``outliers`` gross
    ones appended last) solved by the JAX package and by the port's "ell"
    formulation on the CPU in ``dtype``, 8 agents: mu, the GNC stage and
    the final weights of both.  ``continued`` runs ``max_iters`` more
    rounds from each side's state, as chip_smoke.py does, where the
    anneal freezes."""
    meas = tsyn.make_measurements(np.random.default_rng(0), n=n, d=3,
                                  num_lc=round(n * 2449 / 2500),
                                  rot_noise=0.01, trans_noise=0.01,
                                  outlier_lc=outliers)[0]
    kw = dict(max_iters=max_iters, grad_norm_tol=0.1, eval_every=eval_every)
    jp, tp = _standin_params(jconfig), _standin_params(tconfig)
    jprob = jrbcd.prepare_problem(meas, 8, jp, dtype=getattr(jnp, dtype))
    tprob = rbcd.prepare_problem(meas, 8, tp, dtype=getattr(torch, dtype),
                                 device="cpu")
    jres = jrbcd.dispatch_prepared(jprob, **kw)
    tres = rbcd.dispatch_prepared(tprob, **kw)
    if continued:
        jres = jrbcd.dispatch_prepared(jprob, state=jres.state, **kw)
        tres = rbcd.dispatch_prepared(tprob, state=tres.state, **kw)
    jw, tw = np.asarray(jres.weights, np.float64), \
        tres.weights.double().numpy()
    out = {}
    for name, res, w, mu, stage in (
            ("jax", jres, jw, float(jres.state.mu),
             jrobust.gnc_stage_index(jres.state.mu, jp.robust)),
            ("port", tres, tw, float(tres.state.mu),
             trobust.gnc_stage_index(tres.state.mu, tp.robust))):
        out[name] = {"iterations": res.iterations,
                     "terminated_by": res.terminated_by, "mu": mu,
                     "gnc_stage": stage,
                     "outliers_below_half": int((w[-outliers:] < 0.5).sum()),
                     "inliers_below_half": int((w[:-outliers] < 0.5).sum())}
    out.update(poses=n, measurements=len(meas), outliers=outliers,
               dtype=dtype, continued=continued,
               flips_at_half=int(((jw < 0.5) != (tw < 0.5)).sum()),
               max_abs_dw=float(np.abs(jw - tw).max()), weights=(jw, tw))
    return out


def test_gnc_standin_matches_jax():
    """The reduced stand-in (300 poses, 6 gross outliers, float64), run on
    until the anneal freezes (stage 23, as at full size on the card): the
    port freezes at the JAX package's mu and stage with its weights."""
    out = gnc_standin(300, 6, "float64", continued=True)
    j, t = out["jax"], out["port"]
    assert (t["iterations"], t["terminated_by"]) == (j["iterations"],
                                                     j["terminated_by"])
    assert t["gnc_stage"] == j["gnc_stage"] == 23
    assert t["terminated_by"] == "grad_norm"
    np.testing.assert_allclose(t["mu"], j["mu"], rtol=1e-9)
    np.testing.assert_allclose(*out["weights"][::-1], rtol=1e-9, atol=1e-12)
    assert j["outliers_below_half"] == 6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--poses", type=int, default=2500)
    ap.add_argument("--outliers", type=int, default=50)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    for continued in (False, True):
        out = gnc_standin(args.poses, args.outliers, args.dtype,
                          continued=continued)
        del out["weights"]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

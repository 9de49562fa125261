"""The port's RBCD rounds and its whole single-device solve
(``dpgo_tpu_torch.models.rbcd``) against the JAX package's, in float64 on
the CPU, fed identical inputs through ``dpgo_tpu_torch.interop``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.config import ROptAlg as JROptAlg
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.config import (AgentParams, RobustCostParams,
                                   RobustCostType, ROptAlg, Schedule,
                                   SolverParams)
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import rtr_kernel
from dpgo_tpu_torch.utils.synthetic import make_measurements as t_make


def _meas(seed=0, n=30, num_lc=10, d=3):
    return make_measurements(np.random.default_rng(seed), n=n, d=d,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05)[0]


@pytest.mark.parametrize("alg", ["RTR", "RGD"])
def test_jacobi_rounds_match_jax(alg):
    prob = jrbcd.prepare_problem(_meas(), 3, dtype=jnp.float64,
                                 pallas_sel=True)
    jp = JAgentParams(d=3, r=5, num_robots=3)
    tp = AgentParams(d=3, r=5, num_robots=3)
    if alg == "RGD":
        from dpgo_tpu.config import SolverParams as JSolverParams

        jp = JAgentParams(d=3, r=5, num_robots=3, solver=JSolverParams(
            algorithm=JROptAlg.RGD, rgd_stepsize=1e-2))
        tp = AgentParams(d=3, r=5, num_robots=3, solver=SolverParams(
            algorithm=ROptAlg.RGD, rgd_stepsize=1e-2))
    js = jrbcd.init_state(prob.graph, prob.meta, prob.X0, params=jp)
    graph = interop.graph_from_numpy(jax.tree.map(np.asarray, prob.graph),
                                     device="cpu")
    meta = interop.meta_from_numpy(prob.meta)
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js),
                                  device="cpu")
    np.testing.assert_allclose(ts.chol.numpy(), np.asarray(js.chol),
                               rtol=1e-12)
    for _ in range(3):
        js = jrbcd.rbcd_step(js, prob.graph, prob.meta, jp)
        ts = rbcd._rbcd_round(ts, graph, meta, tp)
    np.testing.assert_allclose(ts.X.numpy(), np.asarray(js.X), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(ts.rel_change.numpy(),
                               np.asarray(js.rel_change), rtol=1e-9)
    assert ts.iteration == int(js.iteration) == 3
    assert np.array_equal(ts.ready.numpy(), np.asarray(js.ready))


def test_solve_rbcd_matches_jax():
    meas = _meas(seed=1, n=36, num_lc=12)
    ref = jrbcd.solve_rbcd(meas, 3, max_iters=20, grad_norm_tol=0.1)
    t_meas = t_make(np.random.default_rng(1), n=36, d=3, num_lc=12,
                    rot_noise=0.05, trans_noise=0.05)[0]
    res = rbcd.solve_rbcd(t_meas, 3, max_iters=20, grad_norm_tol=0.1,
                          device="cpu", dtype=torch.float64)
    assert res.iterations == ref.iterations
    assert res.terminated_by == ref.terminated_by
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), atol=1e-8)
    assert res.weights.shape == (len(meas),)


def _port_problem(dtype=torch.float32, d=3, r=5):
    meas = t_make(np.random.default_rng(2), n=24, d=d, num_lc=8,
                  rot_noise=0.05, trans_noise=0.05)[0]
    return rbcd.prepare_problem(meas, 3, AgentParams(d=d, r=r,
                                                     num_robots=3),
                                dtype=dtype, device="cpu")


def test_kernel_formulation_on_cpu_tracks_ell_path():
    """Forced kernel formulation: on CPU tensors the wrapper runs the
    kernel's plain version (no launch); its rounds track the ELL path."""
    prob = _port_problem()
    pk = AgentParams(d=3, r=5, num_robots=3,
                     solver=SolverParams(pallas_tcg=True))
    pe = AgentParams(d=3, r=5, num_robots=3,
                     solver=SolverParams(pallas_tcg=False))
    g, m = prob.graph, prob.meta
    assert rbcd._formulation(m, pk, g, torch.float32, torch.device("cpu")) \
        == "kernel"
    assert rbcd._formulation(m, AgentParams(), g, torch.float32,
                             torch.device("cpu")) == "ell"
    sk = rbcd.init_state(g, m, prob.X0, pk)
    se = rbcd.init_state(g, m, prob.X0, pe)
    before = rtr_kernel.LAUNCHES
    for _ in range(3):
        sk = rbcd.rbcd_step(sk, g, m, pk)
        se = rbcd.rbcd_step(se, g, m, pe)
    assert rtr_kernel.LAUNCHES == before
    np.testing.assert_allclose(sk.X.numpy(), se.X.numpy(), atol=1e-5)


def test_forced_kernel_that_cannot_run_raises():
    prob = _port_problem(dtype=torch.float64)
    pk = AgentParams(d=3, r=5, num_robots=3,
                     solver=SolverParams(pallas_tcg=True))
    state = rbcd.init_state(prob.graph, prob.meta, prob.X0, pk)
    with pytest.raises(ValueError, match="float32-only"):
        rbcd.rbcd_step(state, prob.graph, prob.meta, pk)
    rgd = AgentParams(d=3, r=5, num_robots=3, solver=SolverParams(
        pallas_tcg=True, algorithm=ROptAlg.RGD))
    with pytest.raises(ValueError, match="not RTR"):
        rbcd.rbcd_step(state, prob.graph, prob.meta, rgd)


@pytest.mark.parametrize("params,kw", [
    (AgentParams(schedule=Schedule.GREEDY), {}),
    (AgentParams(schedule=Schedule.ASYNC), {}),
    (AgentParams(schedule=Schedule.COLORED), {}),
    (AgentParams(acceleration=True), {}),
    (AgentParams(robust=RobustCostParams(
        cost_type=RobustCostType.GNC_TLS)), {}),
    (AgentParams(solver=SolverParams(dense_quadratic=True)), {}),
    (AgentParams(), {"verdict_every": 4}),
])
def test_unported_paths_raise(params, kw):
    prob = _port_problem(dtype=torch.float64)
    prob = rbcd.PreparedProblem(prob.part, prob.graph, prob.meta, params,
                                prob.dtype, prob.X0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rbcd.dispatch_prepared(prob, max_iters=2, **kw)

"""The port's centralized solve (``dpgo_tpu_torch.ops.solver.rtr_solve``,
``rgd_step``, ``rgd_linesearch``; ``models.local_pgo.make_problem``,
``solve_local``) and the global edge-list maps (``ops.quadratic.egrad``,
``hessvec``) against the JAX package's, in float64 on the CPU, on
measurements made with numpy from a seed.

The gradient tolerances sit well above the float64 floor of the RTR
iteration (where f(x_prop) - f(x) is rounding and every step is
rejected, ~1e-7 on these problems): there the iteration at which the
gradient norm crosses a tolerance is decided by rounding in either
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import SolverParams as JSolverParams
from dpgo_tpu.models import local_pgo as jlocal
from dpgo_tpu.ops import chordal as jchordal
from dpgo_tpu.ops import quadratic as jquad
from dpgo_tpu.ops import solver as jsolver
from dpgo_tpu.types import edge_set_from_measurements as j_edges
from dpgo_tpu.utils.lie import lifting_matrix as j_lifting
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch.config import SolverParams
from dpgo_tpu_torch.models import local_pgo
from dpgo_tpu_torch.ops import quadratic, solver
from dpgo_tpu_torch.types import Measurements
from dpgo_tpu_torch.types import edge_set_from_measurements as t_edges

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(d=3, n=20, num_lc=8, seed=0):
    meas = make_measurements(np.random.default_rng(seed), n=n, d=d,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05)[0]
    tmeas = Measurements(**{f: getattr(meas, f)
                            for f in meas.__dataclass_fields__})
    return meas, tmeas


def _problems(meas, tmeas, rank=5, init="chordal"):
    je = j_edges(meas, dtype=jnp.float64)
    te = t_edges(tmeas, dtype=torch.float64, device="cpu")
    n = meas.num_poses
    T0 = (jchordal.chordal_initialization if init == "chordal"
          else jchordal.odometry_from_edges)(je, n)
    X0 = np.array(jlocal.lift(T0, j_lifting(rank, meas.d, jnp.float64)))
    return (jlocal.make_problem(je, n), local_pgo.make_problem(te, n), X0,
            je, te)


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("d", [2, 3])
def test_global_egrad_and_hessvec_match_jax(d):
    meas, tmeas = _pair(d=d)
    _, _, X0, je, te = _problems(meas, tmeas)
    n = meas.num_poses
    _close(jquad.egrad(jnp.asarray(X0), je),
           quadratic.egrad(torch.as_tensor(X0), te), rtol=1e-12, atol=1e-12)
    # Probes ride the r axis: 7 columns, and a buffer with a padded tail.
    V = np.random.default_rng(1).standard_normal((n, 7, d + 1))
    _close(jquad.egrad(jnp.asarray(V), je),
           quadratic.egrad(torch.as_tensor(V), te), rtol=1e-12)
    Vl = V[: n - 3]
    _close(jquad.hessvec(jnp.asarray(Vl), je, n),
           quadratic.hessvec(torch.as_tensor(Vl), te, n), rtol=1e-12,
           atol=1e-12)
    _close(jquad.egrad(jnp.asarray(V), je, n_out=n - 5),
           quadratic.egrad(torch.as_tensor(V), te, n_out=n - 5),
           rtol=1e-12, atol=1e-12)


def test_make_problem_closures_match_jax():
    meas, tmeas = _pair()
    jp, tp, X0, _, _ = _problems(meas, tmeas)
    V = np.random.default_rng(2).standard_normal(X0.shape)
    Xj, Xt = jnp.asarray(X0), torch.as_tensor(X0)
    Vj, Vt = jnp.asarray(V), torch.as_tensor(V)
    _close(jp.cost(Xj), tp.cost(Xt))
    _close(jp.egrad(Xj), tp.egrad(Xt), rtol=1e-12, atol=1e-12)
    _close(jp.ehess(Xj, Vj), tp.ehess(Xt, Vt), rtol=1e-12, atol=1e-12)
    _close(jp.precond(Xj, Vj), tp.precond(Xt, Vt), rtol=1e-12)
    assert solver.identity_precond(Xt, Vt) is Vt


@pytest.mark.parametrize("max_iters,gtol", [(3, 1e-6), (50, 1e-6),
                                            (50, 1e-3)])
def test_rtr_solve_matches_jax(max_iters, gtol):
    meas, tmeas = _pair(seed=3)
    jp, tp, X0, _, _ = _problems(meas, tmeas)
    jparams = JSolverParams(initial_radius=1e1, max_inner_iters=50)
    tparams = SolverParams(initial_radius=1e1, max_inner_iters=50)
    jo = jsolver.rtr_solve(jp, jnp.asarray(X0), jparams,
                           max_iters=max_iters, grad_norm_tol=gtol)
    to = solver.rtr_solve(tp, torch.as_tensor(X0), tparams,
                          max_iters=max_iters, grad_norm_tol=gtol)
    assert int(to.iters) == int(jo.iters)
    assert bool(to.done) == bool(jo.done)
    assert bool(to.accepted) == bool(jo.accepted)
    _close(jo.X, to.X, atol=1e-12)
    _close(jo.f, to.f)
    _close(jo.radius, to.radius)
    _close(jo.grad_norm, to.grad_norm, rtol=1e-6, atol=1e-12)
    _close(jo.grad_norm_init, to.grad_norm_init)


@pytest.mark.parametrize("r0,expect", [(1.0, [2.0, 4.0, 5.0, 5.0]),
                                        (100.0, [25.0, 6.25, 12.5, 12.5])])
def test_rtr_solve_radius_grows_and_shrinks_as_jax(r0, expect):
    """From a random point on the manifold the radius shrinks x0.25 on a
    poor model and grows x2 at the boundary, up to 5x the initial radius,
    iteration for iteration as the JAX package's."""
    from dpgo_tpu.ops import manifold as jmanifold

    meas, tmeas = _pair(seed=3)
    jp, tp, _, _, _ = _problems(meas, tmeas)
    X0 = np.array(jmanifold.project(jnp.asarray(
        np.random.default_rng(3).standard_normal((meas.num_poses, 5, 4)))))
    radii = []
    for it in range(1, 5):
        jo = jsolver.rtr_solve(jp, jnp.asarray(X0), JSolverParams(
            initial_radius=r0, max_inner_iters=20), max_iters=it,
            grad_norm_tol=0.0)
        to = solver.rtr_solve(tp, torch.as_tensor(X0), SolverParams(
            initial_radius=r0, max_inner_iters=20), max_iters=it,
            grad_norm_tol=0.0)
        _close(jo.radius, to.radius)
        _close(jo.f, to.f)
        _close(jo.X, to.X, atol=1e-12)
        radii.append(float(to.radius))
    assert radii == expect


def test_rgd_step_and_linesearch_match_jax():
    meas, tmeas = _pair(seed=5)
    jp, tp, X0, _, _ = _problems(meas, tmeas)
    Xj, Xt = jnp.asarray(X0), torch.as_tensor(X0)
    _close(jsolver.rgd_step(jp, Xj, 1e-3), solver.rgd_step(tp, Xt, 1e-3),
           atol=1e-14)
    for kw in ({}, {"max_iters": 30, "grad_norm_tol": 1e-4},
               {"max_iters": 5, "initial_step": 10.0, "max_backtracks": 3}):
        _close(jsolver.rgd_linesearch(jp, Xj, **kw),
               solver.rgd_linesearch(tp, Xt, **kw), atol=1e-12)


@pytest.mark.parametrize("d,init,rank", [
    (3, "chordal", 5), (3, "odometry", 3), (2, "chordal", 2),
    (2, "odometry", 5)])
def test_solve_local_matches_jax(d, init, rank):
    meas, tmeas = _pair(d=d, seed=6)
    jr = jlocal.solve_local(meas, rank=rank, grad_norm_tol=1e-6,
                            max_iters=200, init=init)
    tr = local_pgo.solve_local(tmeas, rank=rank, grad_norm_tol=1e-6,
                               max_iters=200, init=init, device="cpu")
    assert tr.iters == jr.iters
    _close(jr.cost, tr.cost)
    _close(jr.X, tr.X, atol=1e-12)
    _close(jr.T, tr.T, rtol=1e-9, atol=1e-12)
    assert tr.grad_norm < 1e-6 and tr.X.shape == (meas.num_poses, rank,
                                                  d + 1)


def test_solve_local_rejects_unknown_init_and_defaults_to_cuda():
    _, tmeas = _pair(n=8, num_lc=2)
    with pytest.raises(ValueError, match="unknown init"):
        local_pgo.solve_local(tmeas, init="nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            local_pgo.solve_local(tmeas)

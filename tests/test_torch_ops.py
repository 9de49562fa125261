"""The port's numerical operators (``dpgo_tpu_torch.ops``) against the JAX
package's, in float64 on the CPU, on one per-agent RBCD problem built by
the port and handed to both sides as numpy arrays.

Tolerance: rtol 1e-10 (summation order differs between XLA and PyTorch),
with atol 1e-12 for entries that cancel to ~0.  Chordal initialization:
rtol 1e-8, because its two conjugate-gradient solves stop on a 1e-10
relative residual, and a stopping test that flips by one iteration on
rounding moves the solution at that level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import SolverParams as JSolverParams
from dpgo_tpu.ops import chordal as jchordal
from dpgo_tpu.ops import manifold as jmanifold
from dpgo_tpu.ops import quadratic as jquad
from dpgo_tpu.ops import smallmat as jsmall
from dpgo_tpu.ops import solver as jsolver
from dpgo_tpu.types import EdgeSet as JEdgeSet
from dpgo_tpu_torch.config import AgentParams, SolverParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import chordal, manifold, quadratic, smallmat, solver
from dpgo_tpu_torch.types import edge_set_from_measurements
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements

TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def prob():
    meas = make_measurements(np.random.default_rng(11), n=30, d=3,
                             num_lc=10, rot_noise=0.05, trans_noise=0.05)[0]
    part = partition_contiguous(meas, 3)
    graph, meta = rbcd.build_graph(part, 5, torch.float64, device="cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    Z = rbcd.neighbor_buffer(rbcd.public_table(X0, graph), graph)
    chol = rbcd.precond_chol(graph.edges, meta.n_max, meta.s_max,
                             AgentParams())
    return dict(meas=meas, graph=graph, meta=meta, X0=X0, Z=Z, chol=chol)


def _j(t):
    return jnp.asarray(t.numpy())


def _agent(graph, a):
    """Agent ``a``'s edge set on the JAX side."""
    return JEdgeSet(**{k: _j(v[a]) for k, v in graph.edges._asdict().items()})


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def test_quadratic_ops_match_jax(prob):
    g, meta, X0, Z = prob["graph"], prob["meta"], prob["X0"], prob["Z"]
    rng = np.random.default_rng(0)
    buf = torch.cat([X0, Z], dim=1)
    buf = buf + 0.05 * torch.as_tensor(rng.standard_normal(buf.shape))
    V = torch.as_tensor(rng.standard_normal(X0.shape))
    n_buf = meta.n_max + meta.s_max
    cost = quadratic.cost(buf, g.edges)
    eg = quadratic.egrad(buf, g.edges, n_out=meta.n_max)
    eg_ell = quadratic.egrad_ell(buf, g.edges, g.inc_slot, g.inc_mask)
    hv_ell = quadratic.hessvec_ell(V, g.edges, g.inc_slot, g.inc_mask, n_buf)
    blocks = quadratic.diag_blocks(g.edges, n_buf, n_out=meta.n_max)
    L = quadratic.precond_factors(blocks, 0.1)
    pv = quadratic.precond_apply(L, V)
    for a in range(meta.num_robots):
        e = _agent(g, a)
        b = _j(buf[a])
        inc = (_j(g.inc_slot[a]), _j(g.inc_mask[a]))
        _close(cost[a], jquad.cost(b, e))
        _close(eg[a], jquad.egrad(b, e, n_out=meta.n_max))
        _close(eg_ell[a], jquad.egrad_ell(b, e, *inc))
        _close(hv_ell[a], jquad.hessvec_ell(_j(V[a]), e, *inc, n_buf))
        jb = jquad.diag_blocks(e, n_buf, n_out=meta.n_max)
        _close(blocks[a], jb)
        jL = jquad.precond_factors(jb, 0.1)
        _close(L[a], jL)
        _close(pv[a], jquad.precond_apply(jL, _j(V[a])))


def test_manifold_and_smallmat_ops_match_jax(prob):
    X = prob["X0"]
    rng = np.random.default_rng(1)
    V = torch.as_tensor(rng.standard_normal(X.shape))
    G = torch.as_tensor(rng.standard_normal(X.shape))
    M = X + 0.3 * V
    Xj, Vj, Gj, Mj = _j(X), _j(V), _j(G), _j(M)
    _close(manifold.project(M), jmanifold.project(Mj))
    _close(manifold.tangent_project(X, V), jmanifold.tangent_project(Xj, Vj))
    _close(manifold.retract(X, 0.1 * V), jmanifold.retract(Xj, 0.1 * Vj))
    _close(manifold.rgrad(X, G), jmanifold.rgrad(Xj, Gj))
    _close(manifold.ehess_to_rhess(X, G, V, 0.5 * V),
           jmanifold.ehess_to_rhess(Xj, Gj, Vj, 0.5 * Vj))
    _close(manifold.inner(V, G), jmanifold.inner(Vj, Gj))
    _close(manifold.norm(V), jmanifold.norm(Vj))
    Y = M[..., :-1]
    for sweeps in (24, 40):
        _close(smallmat.polar_orthonormalize(Y, sweeps),
               jsmall.polar_orthonormalize(_j(Y), sweeps))
    A = torch.as_tensor(rng.standard_normal((7, 4, 4)))
    A = A @ A.transpose(-1, -2) + 0.1 * torch.eye(4)
    B = torch.as_tensor(rng.standard_normal((7, 4, 5)))
    _close(smallmat.cholesky_small(A), jsmall.cholesky_small(_j(A)))
    _close(smallmat.cho_solve_small(smallmat.cholesky_small(A), B),
           jsmall.cho_solve_small(jsmall.cholesky_small(_j(A)), _j(B)))


def _problems(prob):
    """The same local problem closures on both sides, for every agent."""
    g, meta, Z, chol = prob["graph"], prob["meta"], prob["Z"], prob["chol"]
    n_buf = meta.n_max + meta.s_max

    def buf(X):
        return torch.cat([X, Z], dim=1)

    port = solver.Problem(
        cost=lambda X: quadratic.cost(buf(X), g.edges),
        egrad=lambda X: quadratic.egrad_ell(buf(X), g.edges, g.inc_slot,
                                            g.inc_mask),
        ehess=lambda X, V: quadratic.hessvec_ell(V, g.edges, g.inc_slot,
                                                 g.inc_mask, n_buf),
        precond=lambda X, V: quadratic.precond_apply(chol, V))

    def jax_problem(a):
        e, z = _agent(g, a), _j(Z[a])
        inc = (_j(g.inc_slot[a]), _j(g.inc_mask[a]))
        c = _j(chol[a])
        return jsolver.Problem(
            cost=lambda X: jquad.cost(jnp.concatenate([X, z]), e),
            egrad=lambda X: jquad.egrad_ell(jnp.concatenate([X, z]), e,
                                            *inc),
            ehess=lambda X, V: jquad.hessvec_ell(V, e, *inc, n_buf),
            precond=lambda X, V: jquad.precond_apply(c, V))

    return port, jax_problem


@pytest.mark.parametrize("radius", [0.05, 100.0])
def test_truncated_cg_matches_jax(prob, radius):
    port, jax_problem = _problems(prob)
    X = prob["X0"]
    eg = port.egrad(X)
    g = manifold.rgrad(X, eg)
    res = solver.truncated_cg(
        X, g, lambda V: manifold.ehess_to_rhess(X, eg, port.ehess(X, V), V),
        lambda V: manifold.tangent_project(X, port.precond(X, V)),
        torch.full((X.shape[0],), radius, dtype=X.dtype), 10)
    for a in range(X.shape[0]):
        jp, x = jax_problem(a), _j(X[a])
        jeg = jp.egrad(x)
        ref = jax.jit(lambda x, jeg, jg: jsolver.truncated_cg(
            x, jg, lambda V: jmanifold.ehess_to_rhess(x, jeg, jp.ehess(x, V),
                                                      V),
            lambda V: jmanifold.tangent_project(x, jp.precond(x, V)),
            jnp.asarray(radius), 10))(x, jeg, jmanifold.rgrad(x, jeg))
        _close(res.eta[a], ref.eta)
        _close(res.heta[a], ref.heta)
        assert int(res.iters[a]) == int(ref.iters)
        assert bool(res.hit_boundary[a]) == bool(ref.hit_boundary)


def test_rtr_single_step_matches_jax(prob):
    port, jax_problem = _problems(prob)
    X = prob["X0"]
    out = solver.rtr_single_step(port, X, SolverParams())
    for a in range(X.shape[0]):
        jp = jax_problem(a)
        ref = jax.jit(lambda x: jsolver.rtr_single_step(
            jp, x, JSolverParams()))(_j(X[a]))
        _close(out.X[a], ref.X)
        for f in ("f", "grad_norm", "grad_norm_init", "radius"):
            _close(getattr(out, f)[a], getattr(ref, f))
        assert int(out.iters[a]) == int(ref.iters)
        assert bool(out.accepted[a]) == bool(ref.accepted)


def test_chordal_initialization_matches_jax(prob):
    meas = prob["meas"]
    e = edge_set_from_measurements(meas, torch.float64,
                                   device="cpu")
    je = JEdgeSet(**{k: _j(v) for k, v in e._asdict().items()})
    T = chordal.chordal_initialization(e, meas.num_poses)
    np.testing.assert_allclose(
        T.numpy(), jchordal.chordal_initialization(je, meas.num_poses),
        rtol=1e-8, atol=1e-10)

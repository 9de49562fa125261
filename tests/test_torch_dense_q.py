"""The port's dense-Q formulation (``dpgo_tpu_torch.ops.quadratic.dense_q``,
``to_mat``/``from_mat``; ``models.rbcd``'s "dense" rounds, ``use_dense_q``,
``dense_q_all``, ``refresh_problem``, ``RBCDState.Qbuf``) against the JAX
package's, in float64 on the CPU, fed identical inputs through
``dpgo_tpu_torch.interop``.

Each case of ``tests/test_dense_q.py`` has a counterpart.  Tolerances:
``dense_q`` at 1e-12 of its largest entry; ``to_mat``/``from_mat`` exact;
10 dense rounds against JAX's dense rounds at rtol 1e-9; the budget
predicate, the carried ``Qbuf`` and the missing-``Qbuf`` error equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.config import SolverParams as JSolverParams
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.ops import quadratic as jquad
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.config import AgentParams, SolverParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import quadratic, solver

DENSE = dict(solver=SolverParams(dense_quadratic=True))


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread, not a pool spinning on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(rng, n=24, A=4, num_lc=None, noise=0.05):
    meas, _ = make_measurements(rng, n=n, d=3, num_lc=num_lc or n // 2,
                                rot_noise=noise, trans_noise=noise)
    part = jpartition(meas, A)
    jg, jm = jrbcd.build_graph(part, 5, jnp.float64, pallas_sel=True)
    graph = interop.graph_from_numpy(jax.tree.map(np.asarray, jg),
                                     device="cpu")
    return part, jg, jm, graph, interop.meta_from_numpy(jm)


def test_to_from_mat_roundtrip(rng):
    X = rng.standard_normal((2, 6, 5, 4))
    Xm = quadratic.to_mat(torch.as_tensor(X))
    assert np.array_equal(Xm.numpy(), np.asarray(jquad.to_mat(
        jnp.asarray(X))))
    assert torch.equal(quadratic.from_mat(Xm, 6), torch.as_tensor(X))
    assert np.array_equal(
        quadratic.from_mat(Xm, 6).numpy(),
        np.asarray(jquad.from_mat(jnp.asarray(Xm.numpy()), 6)))


def test_dense_q_matches_jax_and_repeats(rng):
    part, jg, jm, graph, meta = _setup(rng)
    Q = rbcd.dense_q_all(graph.edges, meta)
    Qj = np.asarray(jrbcd.dense_q_all(jg.edges, jm))
    K = 4 * (meta.n_max + meta.s_max)
    assert Q.shape == (meta.num_robots, K, K) and Q.dtype == torch.float64
    assert np.abs(Q.numpy() - Qj).max() <= 1e-12 * np.abs(Qj).max()
    torch.testing.assert_close(Q, Q.transpose(-1, -2), rtol=0,
                               atol=1e-12 * float(Q.abs().max()))
    # Bit for bit on a second build, and through the incidence the graph
    # carries (the round's rebuild) as through one built on the spot.
    assert torch.equal(Q, rbcd.dense_q_all(graph.edges, meta))
    assert torch.equal(Q, rbcd.dense_q_all(graph.edges, meta,
                                           graph.dense_inc))


def test_dense_q_sums_duplicate_edges():
    """Two measurements of one pose pair, in either order: Q holds their
    sum, the same as the edge-list gradient, and JAX's."""
    rng = np.random.default_rng(3)
    R = np.linalg.qr(rng.standard_normal((2, 3, 3)))[0]
    from dpgo_tpu_torch.types import EdgeSet
    from dpgo_tpu.types import EdgeSet as JEdgeSet

    f = dict(i=np.array([0, 1, 0]), j=np.array([1, 2, 1]),
             R=np.stack([R[0], R[1], R[1]]), t=rng.standard_normal((3, 3)),
             kappa=np.array([2.0, 3.0, 5.0]), tau=np.array([1.0, 0.5, 4.0]),
             weight=np.ones(3), mask=np.ones(3), is_lc=np.zeros(3),
             fixed_weight=np.zeros(3))
    e = EdgeSet(**{k: torch.as_tensor(v) for k, v in f.items()})
    Q = quadratic.dense_q(e, 3)
    Qj = np.asarray(jquad.dense_q(JEdgeSet(**{k: jnp.asarray(v)
                                              for k, v in f.items()}), 3))
    np.testing.assert_allclose(Q.numpy(), Qj, rtol=0, atol=1e-13)
    X = torch.as_tensor(rng.standard_normal((3, 5, 4)))
    G = quadratic.from_mat(quadratic.to_mat(X) @ Q, 3)
    torch.testing.assert_close(G, quadratic.egrad(X, e), rtol=1e-12,
                               atol=1e-12)


def test_dense_q_problem_matches_edges(rng):
    part, jg, jm, graph, meta = _setup(rng)
    X = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (4, meta.n_max, 5, 4)))
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
    params = AgentParams(d=3, r=5, num_robots=4)
    chol = rbcd.precond_chol(graph.edges, graph, params)
    qbuf = rbcd.dense_q_all(graph.edges, meta)
    # The dense cost is expanded about the round's start X0; at any X it
    # is the edge sum, and JAX's dense cost.
    X0 = X + 0.1 * torch.as_tensor(np.random.default_rng(8)
                                   .standard_normal(X.shape))
    pd = rbcd._agent_local_problem(Z, graph.edges, chol, graph, meta.n_max,
                                   qbuf, X0)
    pe = rbcd._agent_local_problem(Z, graph.edges, chol, graph, meta.n_max)
    torch.testing.assert_close(pd.cost(X), pe.cost(X), rtol=1e-12,
                               atol=1e-9)
    torch.testing.assert_close(pd.cost(X0), pe.cost(X0), rtol=1e-12,
                               atol=1e-9)
    jq = jrbcd.dense_q_all(jg.edges, jm)
    jchol = jrbcd.precond_chol(jg.edges, jm.n_max, jm.s_max,
                               JAgentParams(d=3, r=5, num_robots=4))
    for a in range(4):
        jpd = jrbcd._agent_local_problem(
            jnp.asarray(Z[a].numpy()), jax.tree.map(lambda x: x[a], jg.edges),
            jchol[a], jm.n_max, qbuf=jq[a])
        assert float(pd.cost(X)[a]) == pytest.approx(
            float(jpd.cost(jnp.asarray(X[a].numpy()))), rel=1e-12)
    torch.testing.assert_close(pd.egrad(X), pe.egrad(X), rtol=1e-12,
                               atol=1e-9)
    V = torch.as_tensor(np.random.default_rng(1).standard_normal(X.shape))
    torch.testing.assert_close(pd.ehess(X, V), pe.ehess(X, V), rtol=1e-12,
                               atol=1e-9)


def test_rbcd_dense_rounds_match_jax_and_ell(rng):
    """10 dense rounds against JAX's dense rounds (rtol 1e-9) and against
    the port's "ell" rounds (to float tolerance, as the JAX test holds
    them); the state carried across through ``interop`` keeps ``Qbuf``."""
    meas, _ = make_measurements(rng, n=20, d=3, num_lc=10, rot_noise=0.05,
                                trans_noise=0.05)
    part = jpartition(meas, 4)
    jg, jm = jrbcd.build_graph(part, 5, jnp.float64, pallas_sel=True)
    X0 = jrbcd.centralized_chordal_init(part, jm, jg, jnp.float64)
    jp = JAgentParams(d=3, r=5, num_robots=4,
                      solver=JSolverParams(dense_quadratic=True))
    tp = AgentParams(d=3, r=5, num_robots=4, **DENSE)
    te = AgentParams(d=3, r=5, num_robots=4)
    graph = interop.graph_from_numpy(jax.tree.map(np.asarray, jg),
                                     device="cpu")
    meta = interop.meta_from_numpy(jm)
    assert rbcd.use_dense_q(meta, tp, 8) and jrbcd.use_dense_q(jm, jp, 8)
    assert rbcd._formulation(meta, tp, graph, torch.float64,
                             torch.device("cpu")) == "dense"
    js = jrbcd.init_state(jg, jm, X0, params=jp)
    carried = interop.state_from_numpy(jax.tree.map(np.asarray, js),
                                       device="cpu")
    ts = rbcd.init_state(graph, meta, torch.as_tensor(np.array(X0)), tp)
    se = rbcd.init_state(graph, meta, torch.as_tensor(np.array(X0)), te)
    assert se.Qbuf is None
    assert np.abs(carried.Qbuf.numpy() - np.asarray(js.Qbuf)).max() == 0.0
    np.testing.assert_allclose(ts.Qbuf.numpy(), np.asarray(js.Qbuf),
                               rtol=0, atol=1e-12 * float(
                                   np.abs(js.Qbuf).max()))
    for _ in range(10):
        js = jrbcd.rbcd_step(js, jg, jm, jp)
        ts = rbcd.rbcd_step(ts, graph, meta, tp)
        carried = rbcd.rbcd_step(carried, graph, meta, tp)
        se = rbcd.rbcd_step(se, graph, meta, te)
    for s in (ts, carried):
        np.testing.assert_allclose(s.X.numpy(), np.asarray(js.X), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(s.rel_change.numpy(),
                                   np.asarray(js.rel_change), rtol=1e-9)
        assert s.Qbuf is not None
    assert np.allclose(ts.X.numpy(), se.X.numpy(), atol=1e-7)


def test_dense_opt_in_without_qbuf_raises(rng):
    part, jg, jm, graph, meta = _setup(rng, n=12, A=2, num_lc=4,
                                       noise=0.0)
    X0 = jrbcd.centralized_chordal_init(part, jm, jg, jnp.float64)
    jstate = jrbcd.init_state(jg, jm, X0, params=JAgentParams(
        d=3, r=5, num_robots=2))
    state = rbcd.init_state(graph, meta, torch.as_tensor(np.array(X0)),
                            AgentParams(d=3, r=5, num_robots=2))
    assert state.Qbuf is None
    with pytest.raises(ValueError, match="no Qbuf") as jerr:
        jrbcd.rbcd_step(jstate, jg, jm, JAgentParams(
            d=3, r=5, num_robots=2,
            solver=JSolverParams(dense_quadratic=True)))
    with pytest.raises(ValueError, match="no Qbuf") as terr:
        rbcd.rbcd_step(state, graph, meta,
                       AgentParams(d=3, r=5, num_robots=2, **DENSE))
    assert str(terr.value) == str(jerr.value)


def test_use_dense_q_budget():
    """The predicate equals JAX's on a grid of sizes, both item sizes."""
    on = AgentParams(d=3, r=5, num_robots=8, **DENSE)
    jon = JAgentParams(d=3, r=5, num_robots=8,
                       solver=JSolverParams(dense_quadratic=True))
    assert rbcd.DENSE_Q_BUDGET_BYTES == jrbcd.DENSE_Q_BUDGET_BYTES
    grid = 0
    for A in (1, 8, 64):
        for n_max in (100, 316, 1200, 5000, 100000):
            for s_max in (50, 508, 1000):
                kw = dict(num_robots=A, n_max=n_max, e_max=3 * n_max,
                          s_max=s_max, p_max=s_max, d=3, rank=5)
                m, jm = rbcd.GraphMeta(**kw), jrbcd.GraphMeta(**kw)
                for itemsize in (4, 8):
                    for p, jp in ((on, jon), (None, None),
                                  (AgentParams(), JAgentParams())):
                        assert rbcd.use_dense_q(m, p, itemsize) == \
                            jrbcd.use_dense_q(jm, jp, itemsize)
                        grid += 1
    assert grid == 270
    # The slice shape: 8 agents, n_max 316, s_max 508, float32 — 347.6 MB.
    meta = rbcd.GraphMeta(num_robots=8, n_max=316, e_max=920, s_max=508,
                          p_max=508, d=3, rank=5)
    assert rbcd.use_dense_q(meta, on, 4)
    assert 8 * (4 * (316 + 508)) ** 2 * 4 == 347_635_712


def test_refresh_problem_rebakes_factors(rng):
    meas, _ = make_measurements(rng, n=16, d=3, num_lc=8, rot_noise=0.05,
                                trans_noise=0.05)
    part = jpartition(meas, 2)
    jg, jm = jrbcd.build_graph(part, 5, jnp.float64, pallas_sel=True)
    X0 = jrbcd.centralized_chordal_init(part, jm, jg, jnp.float64)
    jp = JAgentParams(d=3, r=5, num_robots=2,
                      solver=JSolverParams(dense_quadratic=True))
    tp = AgentParams(d=3, r=5, num_robots=2, **DENSE)
    graph = interop.graph_from_numpy(jax.tree.map(np.asarray, jg),
                                     device="cpu")
    meta = interop.meta_from_numpy(jm)
    js = jrbcd.init_state(jg, jm, X0, params=jp)
    ts = rbcd.init_state(graph, meta, torch.as_tensor(np.array(X0)), tp)
    jfresh = jrbcd.refresh_problem(js._replace(weights=js.weights * 0.25),
                                   jg, jm, jp)
    stale = ts._replace(weights=ts.weights * 0.25)
    fresh = rbcd.refresh_problem(stale, graph, meta, tp)
    edges_w = graph.edges._replace(weight=stale.weights)
    assert not torch.allclose(stale.chol,
                              rbcd.precond_chol(edges_w, graph, tp))
    torch.testing.assert_close(fresh.chol, rbcd.precond_chol(edges_w, graph,
                                                             tp))
    assert torch.equal(fresh.Qbuf, rbcd.dense_q_all(edges_w, meta))
    np.testing.assert_allclose(fresh.Qbuf.numpy(), np.asarray(jfresh.Qbuf),
                               rtol=0, atol=1e-12 * float(
                                   np.abs(jfresh.Qbuf).max()))
    np.testing.assert_allclose(fresh.chol.numpy(), np.asarray(jfresh.chol),
                               rtol=1e-12, atol=1e-14)
    # Without the opt-in and without a carried Qbuf, none is built.
    plain = rbcd.refresh_problem(stale._replace(Qbuf=None), graph, meta,
                                 AgentParams(d=3, r=5, num_robots=2))
    assert plain.Qbuf is None


def test_fixed_bound_loops_equal_early_exit(rng):
    """The dense round's loops on CUDA run to their bounds with the
    finished lanes frozen (no host read); on the CPU the same step with the
    fixed bounds gives the early exit's result bit for bit."""
    part, jg, jm, graph, meta = _setup(rng)
    X = torch.as_tensor(np.array(jrbcd.centralized_chordal_init(
        part, jm, jg, jnp.float64)))
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
    params = AgentParams(d=3, r=5, num_robots=4)
    chol = rbcd.precond_chol(graph.edges, graph, params)
    problem = rbcd._agent_local_problem(Z, graph.edges, chol, graph,
                                        meta.n_max,
                                        rbcd.dense_q_all(graph.edges, meta),
                                        X)
    a = solver.rtr_single_step(problem, X, params.solver)
    b = solver.rtr_single_step(problem, X, params.solver, fixed_bounds=True)
    for f in solver.RTRState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f

"""The port's Gauss-Newton-CG tail (``models.refine.gn_tail``, host f64
scipy, and ``parallel.sharded.gn_tail_sharded`` on the mesh) against the
JAX package's on the same f64 iterate: cost histories at rtol 1e-9, the
same CG iteration counts, gradient-norm histories at rtol 1e-9 with an
absolute floor of 1e-11 of the first norm (``GN_ATOL``: a later norm is
the difference of terms of the first norm's size, ~1e-4 of them after three
steps, so its rounding is absolute, not relative); the sharded tail on a
gloo world of 4 ranks against JAX's 4-device mesh; two host reads per
outer step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.models import refine as jrefine
from dpgo_tpu.models.certify import sparse_certificate as jsparse
from dpgo_tpu.parallel import gn_tail_sharded as jgn_sharded
from dpgo_tpu.parallel import make_mesh as jmake_mesh
from dpgo_tpu.parallel import solve_rbcd_sharded as jsolve
from dpgo_tpu.types import edge_set_from_measurements as jedges
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements as jmake
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch.models import rbcd, refine
from dpgo_tpu_torch.models.certify import sparse_certificate
from dpgo_tpu_torch.ops import manifold, quadratic
from dpgo_tpu_torch.parallel import gn_tail_sharded, make_mesh
from dpgo_tpu_torch.parallel.sharded import solve_rbcd_sharded
from dpgo_tpu_torch.parallel.world import spawn_world
from dpgo_tpu_torch.types import edge_set_from_measurements
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

A = 8
CFG = dict(max_outer=3, grad_norm_tol=1e-7)
#: The kill bound of the 4-rank world.  ``python -m
#: dpgo_tpu_torch.experiments.world_timing`` splits such a world: 3-4 s
#: start and join the interpreters, the rest is the job on every rank
#: (eager compute and 1,916 or 3,642 gloo all-reduces, each waiting on the
#: slowest rank), so the world stretches with the host's load: 35-81 s
#: were seen under the tier-1 run's six workers.  Three times the worst.
WORLD_BOUND_S = 240
GN_ATOL = 1e-11


def _meas(pkg, n=48, seed=0, noise=0.05):
    make = tmake if pkg == "torch" else jmake
    return make(np.random.default_rng(seed), n=n, d=3, num_lc=n // 2,
                rot_noise=noise, trans_noise=noise)[0]


def _params(mod):
    return mod.AgentParams(d=3, r=5, num_robots=A, rel_change_tol=0.0)


def _port_problem(rounds=12):
    meas = _meas("torch")
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, 5, torch.float64, "cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    params = _params(tconfig)
    state = rbcd.init_state(graph, meta, X0, params=params)
    state = rbcd.rbcd_steps(state, graph, rounds, meta, params)
    edges = edge_set_from_measurements(part.meas_global,
                                       dtype=torch.float64, device="cpu")
    Xg = rbcd.gather_to_global(state.X, graph, meas.num_poses).numpy()
    return meas, graph, meta, state, Xg, edges


def _jax_problem(rounds=12):
    meas = _meas("jax")
    part = jpartition(meas, A)
    graph, meta = jrbcd.build_graph(part, 5, jnp.float64)
    X0 = jrbcd.centralized_chordal_init(part, meta, graph, jnp.float64)
    params = _params(jconfig)
    state = jrbcd.init_state(graph, meta, X0, params=params)
    state = jrbcd.rbcd_steps(state, graph, rounds, meta, params)
    edges = jedges(part.meas_global, dtype=jnp.float64)
    Xg = np.asarray(jrbcd.gather_to_global(state.X, graph, meas.num_poses))
    return graph, meta, state, Xg, edges


def _same_tail(got, ref):
    np.testing.assert_allclose(got.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(got.grad_norm_history, ref.grad_norm_history,
                               rtol=1e-9,
                               atol=GN_ATOL * ref.grad_norm_history[0])
    assert got.cg_iterations == ref.cg_iterations
    assert got.outer_iterations == ref.outer_iterations
    assert got.terminated_by == ref.terminated_by


def test_gradient_matches_driver_oracle():
    """X S is the centralized Riemannian gradient: the tail's gate equals
    run_rbcd's ``manifold.norm(rgrad)``."""
    _, _, _, _, Xg, edges = _port_problem()
    X = torch.as_tensor(Xg)
    gn_ref = float(manifold.norm(manifold.rgrad(
        X, quadratic.egrad(X, edges))))
    S = sparse_certificate(Xg, edges)
    n, r, dh = Xg.shape
    grad = refine._gn_tangent(
        Xg, (Xg.transpose(1, 0, 2).reshape(r, n * dh) @ S)
        .reshape(r, n, dh).transpose(1, 0, 2), 3)
    assert abs(float(np.sqrt(np.sum(grad * grad))) - gn_ref) \
        <= 1e-9 * max(gn_ref, 1.0)


def test_host_gn_tail_matches_jax():
    _, _, _, _, Xg, edges = _port_problem()
    _, _, _, jXg, jedges_g = _jax_problem()
    np.testing.assert_allclose(Xg, jXg, rtol=1e-10, atol=1e-12)
    got = refine.gn_tail(Xg, edges, refine.GNTailConfig(**CFG))
    ref = jrefine.gn_tail(jXg, jedges_g, jrefine.GNTailConfig(**CFG))
    _same_tail(got, ref)
    np.testing.assert_allclose(got.X, ref.X, rtol=1e-8, atol=1e-10)
    assert got.grad_norm_history[-1] < got.grad_norm_history[0] * 1e-2
    assert all(b <= a for a, b in zip(got.cost_history,
                                      got.cost_history[1:]))


def test_diag_and_precond_blocks_match_jax():
    _, graph, meta, state, Xg, edges = _port_problem()
    jgraph, jmeta, jstate, jXg, jedges_g = _jax_problem()
    S = sparse_certificate(Xg, edges)
    n, dh = Xg.shape[0], Xg.shape[2]
    blocks = refine._gn_diag_blocks(S, n, dh, 0.1)
    jblocks = jrefine._gn_diag_blocks(jsparse(jXg, jedges_g), n, dh, 0.1)
    np.testing.assert_allclose(blocks, jblocks, rtol=1e-12, atol=1e-12)
    dense = S.toarray()
    for i in (0, n // 2, n - 1):
        sl = slice(i * dh, (i + 1) * dh)
        np.testing.assert_allclose(blocks[i] - 0.1 * np.eye(dh),
                                   dense[sl, sl], atol=1e-12)
    lam = torch.randn(A, meta.n_max, 3, 3, dtype=torch.float64)
    lam = 0.5 * (lam + lam.transpose(-1, -2))
    got = refine.gn_precond_blocks(graph.edges, lam, graph.inc_slot,
                                   graph.inc_mask, 3, 0.1)
    ref = jrefine.gn_precond_blocks(jgraph.edges, jnp.asarray(lam.numpy()),
                                    jmeta.n_max, jmeta.s_max, 3, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("hist,kw", [
    ([5.0] * 8, {}),
    ([5.0, 4.0, 3.0, 2.0, 1.5, 1.2, 1.1, 1.05], {}),
    ([5.0] * 7, {}),
    ([0.05] * 8, {}),
    ([5.0] * 7 + [float("nan")], {}),
    ([1.0, 0.999, 0.998, 0.997], dict(window=4, rtol=1e-2)),
])
def test_stall_handoff_matches_jax(hist, kw):
    assert refine.stall_handoff(hist, **kw) == \
        jrefine.stall_handoff(hist, **kw)


def test_no_decrease_terminates_cleanly():
    """At a minimizer polished past the f64 floor no step decreases the
    cost: the tail stops with ``no_decrease`` and the iterate as it was."""
    _, _, _, _, Xg, edges = _port_problem()
    t = refine.gn_tail(Xg, edges, refine.GNTailConfig(max_outer=30,
                                                      grad_norm_tol=0.0))
    assert t.terminated_by == "no_decrease"
    assert np.isfinite(t.cost_history).all()


def test_sharded_tail_world_one_matches_jax_and_reads_twice():
    """World 1 in-process against JAX's 1-device mesh (same CG counts),
    with exactly two ``_host_fetch`` reads per outer step plus the final
    gate."""
    _, graph, meta, state, _, _ = _port_problem()
    jgraph, jmeta, jstate, _, _ = _jax_problem()
    reads = [0]
    orig = rbcd._host_fetch

    def counting(x):
        reads[0] += 1
        return orig(x)

    rbcd._host_fetch = counting
    try:
        Xa, got = gn_tail_sharded(state.X, graph, meta,
                                  mesh=make_mesh(device="cpu"),
                                  cfg=refine.GNTailConfig(**CFG))
    finally:
        rbcd._host_fetch = orig
    _, ref = jgn_sharded(jstate.X, jgraph, jmeta, mesh=jmake_mesh(1),
                         cfg=jrefine.GNTailConfig(**CFG))
    _same_tail(got, ref)
    assert reads[0] == 2 * got.outer_iterations + 1
    host = refine.gn_tail(rbcd.gather_to_global(
        state.X, graph, 48).numpy(), edge_set_from_measurements(
        partition_contiguous(_meas("torch"), A).meas_global,
        dtype=torch.float64, device="cpu"), refine.GNTailConfig(**CFG))
    _same_tail(got, host)
    assert Xa.shape == state.X.shape


def test_sharded_tail_on_four_ranks_matches_jax(tmp_path):
    out = spawn_world(4, "dpgo_tpu_torch.parallel.world:gn_tail_job",
                      kwargs=dict(meas=_meas("torch"), num_robots=A,
                                  params=_params(tconfig), rounds=12,
                                  cfg=refine.GNTailConfig(**CFG)),
                      workdir=tmp_path, timeout_s=WORLD_BOUND_S)
    jgraph, jmeta, jstate, _, _ = _jax_problem()
    _, ref = jgn_sharded(jstate.X, jgraph, jmeta, mesh=jmake_mesh(4),
                         cfg=jrefine.GNTailConfig(**CFG))
    for r in out:
        np.testing.assert_allclose(r["cost_history"], ref.cost_history,
                                   rtol=1e-9)
        np.testing.assert_allclose(r["grad_norm_history"],
                                   ref.grad_norm_history, rtol=1e-9,
                                   atol=GN_ATOL * ref.grad_norm_history[0])
        assert r["cg_iterations"] == ref.cg_iterations
        assert r["terminated_by"] == ref.terminated_by
        assert r["fetches"] == 2 * r["outer_iterations"] + 1
        np.testing.assert_allclose(r["X"], ref.X, rtol=1e-8, atol=1e-10)
        assert np.array_equal(r["Xa"], out[0]["Xa"])


def test_solve_with_gn_tail_extends_histories():
    meas = _meas("torch")
    p = _params(tconfig)
    kw = dict(max_iters=8, verdict_every=4, grad_norm_tol=1e-9)
    cfg = refine.GNTailConfig(max_outer=3, grad_norm_tol=1e-9)
    base = solve_rbcd_sharded(meas, A, params=p, device="cpu", **kw)
    res = solve_rbcd_sharded(meas, A, params=p, device="cpu", gn_tail=cfg,
                             **kw)
    ref = jsolve(_meas("jax"), A, mesh=jmake_mesh(1),
                 params=_params(jconfig), gn_tail=jrefine.GNTailConfig(
                     max_outer=3, grad_norm_tol=1e-9), **kw)
    n = len(base.cost_history)
    assert res.cost_history[:n] == base.cost_history
    assert len(res.cost_history) > n
    assert res.cost_history[-1] < base.cost_history[-1]
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9,
                               atol=GN_ATOL * ref.grad_norm_history[0])
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), rtol=1e-8,
                               atol=1e-9)
    assert res.terminated_by == ref.terminated_by

"""The main path for a few large agents (a team of robots each holding a
large share of the map; on the card B2 and B4 take the grid route where no
spread holds an agent, ``csrc/rtr_grid.cu``) against the JAX package's, in
float64 on the CPU: ``solve_rbcd`` from the odometry init through the
verdict loop, then three refine rounds recentered at its terminal
iterate.  On the CPU every wrapper runs its kernel's plain version,
whatever route is forced; the kernels themselves run only on the card
(``test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.config import SolverParams as JSolverParams
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.models import refine as jrefine
from dpgo_tpu.types import edge_set_from_measurements as jedge_set
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements_vectorized as jmake
from dpgo_tpu_torch.config import AgentParams, SolverParams
from dpgo_tpu_torch.models import rbcd, refine
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils.synthetic import make_measurements_vectorized

#: BASELINE.md config #5's generator and noise (seed 11, noise 0.05, loop
#: closures 20% of the poses) at 2,000 poses over two robots; rounds and K
#: of the solve, refine rounds after it.
POSES, ROBOTS, SEED, NOISE, LC = 2000, 2, 11, 0.05, 0.2
ROUNDS, K, REFINE_ROUNDS = 8, 4, 3
#: Refinement computes in float32 in both packages (its constants ship as
#: float32), each summing in its own order: after three rounds from an
#: iterate this far from the optimum (corrections up to ~5, gradient norms
#: ~1e4) the two agree to float32 rounding, D within this share of its
#: largest entry and the gradient norms of theirs.
REFINE_RTOL = 1e-5


def _meas(make):
    return make(np.random.default_rng(SEED), POSES, d=3,
                num_lc=int(LC * POSES), rot_noise=NOISE,
                trans_noise=NOISE)[0]


def _solves():
    solver = dict(grad_norm_tol=1e-12)
    jp = JAgentParams(d=3, r=5, num_robots=ROBOTS, rel_change_tol=0.0,
                      solver=JSolverParams(**solver))
    tp = AgentParams(d=3, r=5, num_robots=ROBOTS, rel_change_tol=0.0,
                     solver=SolverParams(**solver))
    kw = dict(max_iters=ROUNDS, grad_norm_tol=0.0, init="odometry",
              verdict_every=K)
    jmeas = _meas(jmake)
    ref = jrbcd.solve_rbcd(jmeas, ROBOTS, jp, **kw)
    tmeas = _meas(make_measurements_vectorized)
    res = rbcd.solve_rbcd(tmeas, ROBOTS, tp, device="cpu",
                          dtype=torch.float64, **kw)
    return jmeas, jp, ref, tmeas, tp, res


def test_solve_and_refine_rounds_match_jax():
    jmeas, jp, ref, tmeas, tp, res = _solves()
    assert res.iterations == ref.iterations == ROUNDS
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9)
    np.testing.assert_allclose(res.state.X.numpy(), np.asarray(ref.state.X),
                               rtol=1e-9, atol=1e-12)

    # Three refine rounds recentered at the terminal iterate, from D = 0.
    part = jpartition(jmeas, ROBOTS)
    jg, jm = jrbcd.build_graph(part, 5, jnp.float32, pallas_sel=False)
    Xg = np.asarray(jrbcd.gather_to_global(ref.state.X, jg, POSES),
                    np.float64)
    eg = jedge_set(part.meas_global, dtype=jnp.float32)
    jr = jrefine.recenter(Xg, jg, jm, jp, eg)
    D_jax = jrefine.refine_rounds(jnp.zeros_like(jr.consts.R), jr.consts, jg,
                                  jm, jp, REFINE_ROUNDS)
    _, gn_jax = jrefine.refine_round(D_jax, jr.consts, jg, jm, jp)

    prob = rbcd.prepare_problem(tmeas, ROBOTS, tp, dtype=torch.float32,
                                init=None, device="cpu")
    tr = refine.recenter(Xg, prob.graph, prob.meta, tp,
                         jax.tree.map(np.asarray, eg))
    before = rk.REFINE_LAUNCHES
    D = refine.refine_rounds(torch.zeros_like(tr.consts.R), tr.consts,
                             prob.graph, prob.meta, tp, REFINE_ROUNDS)
    _, gn = refine.refine_round(D, tr.consts, prob.graph, prob.meta, tp)
    assert rk.REFINE_LAUNCHES == before  # CPU tensors: the plain version
    live = prob.graph.pose_mask.numpy() > 0
    D_jax = np.asarray(D_jax)
    assert float(np.abs(D_jax[live]).max()) > 0
    np.testing.assert_allclose(
        D.numpy()[live], D_jax[live], rtol=0,
        atol=REFINE_RTOL * float(np.abs(D_jax[live]).max()))
    gn_jax = np.asarray(gn_jax)
    np.testing.assert_allclose(gn.numpy(), gn_jax, rtol=0,
                               atol=REFINE_RTOL * float(np.abs(gn_jax).max()))


def test_forced_grid_runs_the_plain_versions_on_the_cpu():
    # A forced grid route is planned (and refused where the card could not
    # hold it) but runs the plain version on CPU tensors.
    tmeas = _meas(make_measurements_vectorized)
    tp = AgentParams(d=3, r=5, num_robots=ROBOTS)
    prob = rbcd.prepare_problem(tmeas, ROBOTS, tp, dtype=torch.float64,
                                device="cpu")
    g, m, X = prob.graph, prob.meta, prob.X0
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, g), g)
    ops = rbcd.kernel_operands(X, Z, g.edges, rbcd.precond_chol(g.edges, g,
                                                                tp), g)
    kw = rbcd.kernel_options(tp, m)
    before = rk.LAUNCHES
    out = rk.rtr_full(*ops, _grid=rk.H100_SMS // ROBOTS, **kw)
    ref = rk.rtr_full_reference(*ops, **kw)
    assert rk.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
